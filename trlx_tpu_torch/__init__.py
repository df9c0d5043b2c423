"""trlx_tpu_torch: the PyTorch/CUDA port of trlx_tpu for one NVIDIA H100.

Slice 1 ports the serving path: ``serving.ServingEngine`` driven through
``serving.GenerationClient`` over ``models.transformer.TransformerLM``, with
hand-written Hopper kernels for flash prefill (``csrc/flash_fwd.cu``) and
paged decode (``csrc/paged_decode.cu``). The package imports ``torch`` and
numpy, never ``jax`` or ``trlx_tpu``.
"""
