"""The port's kernel build and launch rules, on the CPU (no nvcc, no card):
a library is named after its source AND the headers the source includes, so
an edited header rebuilds every source that includes it and an untouched
one is reused; the paged wrappers hand the decode entry point at lens + 1
and the verify entry point at Q = 1 with lens the same arguments (the
condition for their bit-for-bit equality on the card, which chip_smoke.py
checks); and a bf16 head dim the tensor-core body lacks raises."""

import contextlib
import shutil
import types

import pytest
import torch

from trlx_tpu_torch.ops import _kernels
from trlx_tpu_torch.ops.paged_attention import paged_attention_kernel, paged_verify_attention_kernel

pytestmark = pytest.mark.torch_port

SOURCES = sorted({source for source, _, _ in _kernels.KERNELS.values()})
HEADER = "mma_sm90.cuh"


@pytest.fixture
def csrc_copy(tmp_path):
    """A copy of the package's ``csrc`` to edit."""
    dst = tmp_path / "csrc"
    shutil.copytree(_kernels.CSRC, dst)
    return dst


@pytest.mark.parametrize("source", SOURCES)
def test_every_source_includes_the_shared_header(source):
    assert [p.name for p in _kernels._sources(_kernels.CSRC / source)] == [source, HEADER]


@pytest.mark.parametrize("source", SOURCES)
def test_editing_an_included_header_changes_the_library(csrc_copy, source):
    before = _kernels._lib_path(source, csrc_copy)
    assert before == _kernels._lib_path(source)  # same bytes, same library as the package's
    header = csrc_copy / HEADER
    header.write_text(header.read_text() + "\n// edited\n")
    after = _kernels._lib_path(source, csrc_copy)
    assert after != before and after.parent == before.parent and after.name.startswith(f"lib{source[:-3]}-")


@pytest.mark.parametrize("source", SOURCES)
def test_editing_the_source_changes_the_library_and_a_stray_file_does_not(csrc_copy, source):
    before = _kernels._lib_path(source, csrc_copy)
    (csrc_copy / "unrelated.cuh").write_text("// no source includes this\n")
    assert _kernels._lib_path(source, csrc_copy) == before
    src = csrc_copy / source
    src.write_text(src.read_text() + "\n// edited\n")
    assert _kernels._lib_path(source, csrc_copy) != before


def test_an_edited_nested_include_changes_the_library(csrc_copy):
    """Includes are followed transitively: a header the shared header
    includes is part of every library's hash."""
    before = _kernels._lib_path("paged_decode.cu", csrc_copy)
    header = csrc_copy / HEADER
    header.write_text('#include "nested.cuh"\n' + header.read_text())
    (csrc_copy / "nested.cuh").write_text("// v1\n")
    with_nested = _kernels._lib_path("paged_decode.cu", csrc_copy)
    (csrc_copy / "nested.cuh").write_text("// v2\n")
    assert len({before, with_nested, _kernels._lib_path("paged_decode.cu", csrc_copy)}) == 3


class _FakeCuda:
    type = "cuda"


@pytest.fixture
def on_fake_card(monkeypatch):
    """Every tensor passes for one on a CUDA card, and the paged kernels'
    library records each call's arguments instead of launching; yields the
    list of (entry point, arguments)."""
    fake = _FakeCuda()  # one device object, so every tensor sits "on the same card"
    calls = []

    class Lib:
        def __getattr__(self, entry):
            return lambda *args: calls.append((entry, args)) or 0

    monkeypatch.setattr(torch.Tensor, "device", property(lambda self: fake))
    monkeypatch.setattr(_kernels, "library", lambda name: Lib())
    monkeypatch.setattr(_kernels, "count_launch", lambda name: None)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: types.SimpleNamespace(cuda_stream=7))
    yield calls


@pytest.mark.parametrize("BS", [8, 16])
@pytest.mark.parametrize("heads", [(12, 12), (12, 3), (32, 8), (12, 1)], ids=str)
@pytest.mark.parametrize("kv", ["f32", "bf16", "int8"])
def test_verify_at_q1_passes_the_decode_call(on_fake_card, kv, heads, BS):
    """What the two wrappers hand the C entry points: verify at Q = 1 with
    lens passes decode's arguments at lens + 1 (the same tensors, geometry,
    scale and dtype codes; Q = 1 added, lens in place of lens + 1, each its
    own output), as
    many as the entry points' argtypes declare. The kernel derives its grid
    from these alone, so the two launch alike (their bit-for-bit equality on
    the card is chip_smoke.py's)."""
    H, Hkv = heads
    B, D, MB = 3, 64, 4
    dtype = torch.float32 if kv == "f32" else torch.bfloat16
    pool_dtype = torch.int8 if kv == "int8" else dtype
    q = torch.zeros((B, H, D), dtype=dtype)
    k_pool = torch.zeros((B * MB, BS, Hkv, D), dtype=pool_dtype)
    v_pool = torch.zeros_like(k_pool)
    scales = {}
    if kv == "int8":
        scales = {"k_scale": torch.ones((B * MB, BS, Hkv)), "v_scale": torch.ones((B * MB, BS, Hkv))}
    tables = torch.arange(B * MB, dtype=torch.int32).reshape(B, MB)
    lens = torch.tensor([0, 5, BS * MB - 1], dtype=torch.int32)
    lens1 = lens + 1
    paged_attention_kernel(q, k_pool, v_pool, tables, lens1, **scales)
    paged_verify_attention_kernel(q[:, None], k_pool, v_pool, tables, lens, **scales)
    (decode, d_args), (verify, v_args) = on_fake_card
    assert (decode, verify) == ("paged_decode", "paged_verify")
    assert len(d_args) == len(_kernels.KERNELS[decode][2]) and len(v_args) == len(_kernels.KERNELS[verify][2])
    assert d_args[6] == lens1.data_ptr() and v_args[6] == lens.data_ptr()
    assert v_args[9] == 1  # Q
    assert d_args[:6] + d_args[8:] == v_args[:6] + v_args[8:9] + v_args[10:]  # all but lens, out and Q
    assert d_args[8:14] == (B, H, Hkv, D, BS, MB)


@pytest.mark.parametrize("entry", ["decode", "verify"])
def test_bf16_head_dims_outside_the_tensor_core_set_raise(monkeypatch, entry):
    """A bf16 head dim the tensor-core body lacks raises before any build,
    on a tensor that passes for a CUDA one; the wrappers never fall back."""
    fake = _FakeCuda()  # one device object, so every tensor sits "on the same card"

    q_shape = (2, 12, 40) if entry == "decode" else (2, 3, 12, 40)
    q = torch.zeros(q_shape, dtype=torch.bfloat16)
    pool = torch.zeros((5, 16, 12, 40), dtype=torch.bfloat16)
    tables, lens = torch.zeros((2, 4), dtype=torch.int32), torch.ones(2, dtype=torch.int32)
    monkeypatch.setattr(torch.Tensor, "device", property(lambda self: fake))
    monkeypatch.setattr(_kernels, "library", lambda name: pytest.fail("no build for an unsupported head dim"))
    fn = paged_attention_kernel if entry == "decode" else paged_verify_attention_kernel
    with pytest.raises(ValueError, match="head dim 40"):
        fn(q, pool, pool, tables, lens)


def _switch_head_dims(source):
    """The head dims of every ``switch (D)`` block of a CUDA source: its
    ``case N:`` labels or ``..._CASE(N)`` lines, one tuple a block."""
    import re

    text = (_kernels.CSRC / source).read_text()
    blocks = re.findall(r"switch \(D\) \{(.*?)default:", text, re.S)
    return [tuple(int(n) for n in re.findall(r"(?:case |_CASE\()(\d+)", block)) for block in blocks]


@pytest.mark.parametrize("source, blocks", [("flash_fwd.cu", 2), ("flash_bwd.cu", 2), ("paged_decode.cu", 1)])
def test_switch_head_dims_equal_the_wrappers_sets(source, blocks):
    """The dispatch in the CUDA sources and the wrappers' checks name the same
    head dims: the flash forward's f32 and bf16 switches and the backward's
    two equal ``FLASH_HEAD_DIMS``, the paged tensor-core switch
    ``PAGED_MMA_HEAD_DIMS`` (the paged f32 body takes any D at run time)."""
    from trlx_tpu_torch.ops.attention import FLASH_HEAD_DIMS
    from trlx_tpu_torch.ops.paged_attention import PAGED_MMA_HEAD_DIMS

    want = PAGED_MMA_HEAD_DIMS if source == "paged_decode.cu" else FLASH_HEAD_DIMS
    assert _switch_head_dims(source) == [want] * blocks
    assert FLASH_HEAD_DIMS == PAGED_MMA_HEAD_DIMS == (16, 32, 64, 80, 96, 128, 256)


@pytest.mark.parametrize("D", [48, 112, 160, 192, 264])
def test_flash_head_dims_outside_the_set_raise(monkeypatch, D):
    """A head dim no switch holds raises before any build on a tensor that
    passes for a CUDA one, f32 and bf16 alike."""
    from trlx_tpu_torch.ops.attention import flash_attention

    fake = _FakeCuda()
    monkeypatch.setattr(torch.Tensor, "device", property(lambda self: fake))
    monkeypatch.setattr(_kernels, "library", lambda name: pytest.fail("no build for an unsupported head dim"))
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.zeros((1, 2, 8, D), dtype=dtype)
        valid = torch.ones((1, 8), dtype=torch.int32)
        with pytest.raises(ValueError, match=f"head dim {D} not in"):
            flash_attention(q, q, q, valid)
