"""TX005 and TX008 (``trlx_tpu_torch/analysis/rules_spmd.py``) against the
JAX package's JX005 and JX008: every JX005 / JX008 case of
``tests/test_analysis.py``, written in the port's idiom (``mesh.group``,
``mesh.shape[...]``, the port's ``PartitionSpec`` and ``shard_tensor``),
is found on the same line with the same class of message, and each clean
case stays clean. Then the port's own places (spec-entry comparisons,
``spec_dim``, ``coords``, ``ranks_with``), the whole port clean, and a
literal planted in a copy of ``parallel/pipeline.py`` found."""

import textwrap
from pathlib import Path

import pytest

from trlx_tpu.analysis import run as jax_run
from trlx_tpu_torch.analysis.core import run

pytestmark = pytest.mark.torch_port

ROOT = Path(__file__).resolve().parent.parent

JAX_HEAD = ("import jax\nfrom jax.sharding import PartitionSpec\n"
            "from trlx_tpu.parallel.mesh import FSDP_AXIS, MODEL_AXIS\n")
PORT_HEAD = ("import torch\nfrom trlx_tpu_torch.parallel.sharding import PartitionSpec, shard_tensor\n"
             "from trlx_tpu_torch.parallel.mesh import FSDP_AXIS, MODEL_AXIS\n")

#: (case of tests/test_analysis.py, JAX body, port body, message class per finding)
CASES = [
    ("jx005_hard_coded_known_axis", 'def f(x):\n    return jax.lax.psum(x, "model")\n',
     'def f(mesh):\n    return mesh.group("model")\n', ["MODEL_AXIS"]),
    ("jx005_unknown_axis", 'def f(x):\n    return jax.lax.pmean(x, "tensor")\n',
     'def f(mesh):\n    return mesh.shape["tensor"]\n', ["unknown mesh axis"]),
    ("jx005_mesh_constant_is_clean", "def f(x):\n    return jax.lax.psum(x, MODEL_AXIS)\n",
     "def f(mesh):\n    return mesh.group(MODEL_AXIS)\n", []),
    ("jx005_axis_name_kwarg_on_any_call", 'def f(x):\n    return ring_attention(x, axis_name="model")\n',
     'def f(x):\n    return ring_attention(x, axis_name="model")\n', ["ring_attention"]),
    ("jx005_parameter_default", 'def attn(x, axis_name="model"):\n    return x\n',
     'def attn(x, axis_name="model"):\n    return x\n', ["default of attn"]),
    ("jx005_from_import_and_tuple_axes",
     'from jax.lax import psum\ndef f(x):\n    return psum(x, ("data", "fsdp"))\n',
     'from trlx_tpu_torch.parallel import mesh as m\ndef f(mesh):\n    return mesh.axis_index(("data", "fsdp"))\n',
     ["hard-coded", "hard-coded"]),
    ("jx005_axis_index_positional", 'def f():\n    return jax.lax.axis_index("data")\n',
     'def f(mesh):\n    return mesh.axis_index("data")\n', ["DATA_AXIS"]),
    ("jx005_variable_axis_is_clean", "def f(x, axis):\n    return jax.lax.psum(x, axis)\n",
     "def f(mesh, axis):\n    return mesh.group(axis)\n", []),
    ("jx008_unknown_axis", 'SPEC = PartitionSpec("tensor", None)\n', 'SPEC = PartitionSpec("tensor", None)\n',
     ["not in the mesh vocabulary"]),
    ("jx008_duplicate_axis", 'SPEC = PartitionSpec("model", "model")\n', 'SPEC = PartitionSpec("model", "model")\n',
     ["appears twice"]),
    ("jx008_duplicate_via_tuple_entry", 'SPEC = PartitionSpec(("fsdp", "model"), "model")\n',
     'SPEC = PartitionSpec(("fsdp", "model"), "model")\n', ["appears twice"]),
    ("jx008_vocabulary_axes_are_clean", 'A = PartitionSpec("data", None, "model")\n'
     'B = PartitionSpec(FSDP_AXIS, MODEL_AXIS)\n',
     'A = PartitionSpec("data", None, "model")\nB = PartitionSpec(FSDP_AXIS, MODEL_AXIS)\n', []),
    ("jx008_local_alias_is_followed", 'P = PartitionSpec\nSPEC = P("tensor")\n',
     'P = PartitionSpec\nSPEC = P("tensor")\n', ["not in the mesh vocabulary"]),
    ("jx008_rule_table_rank_drift", 'RULES = [\n    (r".*bias$", PartitionSpec("model", "fsdp")),\n]\n',
     'RULES = [\n    (r".*bias$", PartitionSpec("model", "fsdp")),\n]\n', ["rank-1"]),
    ("jx008_layers_scan_rule_gets_extra_dim",
     'RULES = [\n    (r".*layers_scan/.*kernel$", PartitionSpec("pipe", "fsdp", "model")),\n]\n',
     'RULES = [\n    (r".*layers_scan/.*kernel$", PartitionSpec("pipe", "fsdp", "model")),\n]\n', []),
    ("jx008_sharding_constraint_over_rank",
     "def f(x):\n    return jax.lax.with_sharding_constraint(\n"
     "        x, PartitionSpec(None, None, None, None)\n    )\n",
     "def f(x, mesh):\n    return shard_tensor(\n"
     "        x, PartitionSpec(None, None, None, None), mesh\n    )\n", ["rank 4"]),
]


def _findings(runner, tmp_path, name, source, rule):
    path = tmp_path / name
    path.write_text(source)
    return [(f.lineno, f.message) for f in runner([str(path)], select=[rule])]


@pytest.mark.parametrize("case, jax_body, port_body, classes", CASES, ids=[c[0] for c in CASES])
def test_the_port_rule_finds_what_the_jax_rule_finds(tmp_path, case, jax_body, port_body, classes):
    jx = case[:5].upper()
    want = _findings(jax_run, tmp_path, "jax_snippet.py", JAX_HEAD + jax_body, jx)
    got = _findings(run, tmp_path, "port_snippet.py", PORT_HEAD + port_body, "TX" + jx[2:])
    assert [line for line, _ in got] == [line for line, _ in want], (got, want)
    assert len(got) == len(classes)
    for (_, message), needle in zip(got, classes):
        assert needle in message, (message, needle)
    for (_, message), (_, jax_message) in zip(got, want):  # the same class of message
        cls = next(c for c in ("hard-coded", "unknown mesh axis", "not in the mesh vocabulary", "appears twice",
                               "rank-", "rank ") if c in jax_message)
        assert cls in message, (message, jax_message)


PORT_PLACES = [
    ('def f(spec):\n    for entry in spec:\n        if entry == "model":\n            return 1\n', [3]),
    ('def f(spec):\n    return spec_dim(spec, "model")\n', [2]),
    ('def f(mesh):\n    return mesh.coords["pipe"], mesh.shape.get("fsdp", 1)\n', [2, 2]),
    ('def f(mesh):\n    return mesh.ranks_with({"pipe": 0, "tensor": 1})\n', [2, 2]),
    ('def f(axes):\n    return "seq" in axes\n', [2]),
    ('import re\ndef f(s):\n    return re.match("(?P<model>x)", s).group("model")\n', []),
    ('def f(x):\n    return x.sum(axis=0), x.shape[0]\n', []),
]


@pytest.mark.parametrize("source, lines", PORT_PLACES)
def test_tx005_reads_the_ports_own_places(tmp_path, source, lines):
    got = _findings(run, tmp_path, "mod.py", source, "TX005")
    assert [line for line, _ in got] == lines, got


def test_the_port_is_clean_and_a_planted_literal_is_found(tmp_path):
    pkg = ROOT / "trlx_tpu_torch"
    assert run([str(pkg)], select=["TX005", "TX008"]) == []
    src = (pkg / "parallel" / "pipeline.py").read_text()
    assert src.count("mesh.shape[PIPE_AXIS]") == 1
    planted = tmp_path / "pipeline.py"
    planted.write_text(src.replace("mesh.shape[PIPE_AXIS]", 'mesh.shape["pipe"]'))
    line = 1 + src[:src.index("mesh.shape[PIPE_AXIS]")].count("\n")
    found = run([str(planted)], select=["TX005"])
    assert [(f.lineno, f.rule) for f in found] == [(line, "TX005")]
    assert "PIPE_AXIS" in found[0].message
    noqa = tmp_path / "noqa.py"
    noqa.write_text(textwrap.dedent('''\
        def f(mesh):
            return mesh.group("model")  # graftcheck: noqa[TX005] a fixture of this test
    '''))
    assert run([str(noqa)], select=["TX005"]) == []
