"""The census: the eager counterpart of the reference's ``analysis/ir`` and
``analysis/rt`` suites.

XLA compiles each hot step once, so the reference audits the compiled
program (collectives, memory, host callbacks) and counts compiles. Eager
PyTorch pays per launch, every step, so the port counts what one step asks
of the device: aten ops, heavy f32 ops in a bf16 step, host round-trips,
distinct shape signatures (warmup against steady state), and on the card
kernel launches, synchronizing calls and peak memory
(:mod:`~trlx_tpu_torch.analysis.census.measure`), for every registered hot
entrypoint (:mod:`~trlx_tpu_torch.analysis.census.entrypoints`), held to
the committed ``budget.json`` (:mod:`~trlx_tpu_torch.analysis.census.budget`)
by ``python -m trlx_tpu_torch.analysis.census``. On a mesh (``--mesh``,
one process per rank: :mod:`~trlx_tpu_torch.analysis.census.ranks`) each
step also records its collectives by ``<kind>:<axes>`` with their bytes
(the reference's IR005), what it staged through host memory and the
optimizer state it holds, and the ranks must count alike. Seeded
regressions (:mod:`~trlx_tpu_torch.analysis.census.seeds`) prove the gate
fails closed.
"""
