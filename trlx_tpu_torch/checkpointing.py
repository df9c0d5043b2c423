"""Native pre-converted checkpoints: convert an HF checkpoint once, restore
onto any mesh with per-rank partial reads (counterpart of
``trlx_tpu/checkpointing.py``, with the same names and the same store).

The store is the one ``trlx_tpu.checkpointing`` writes through orbax's
``StandardCheckpointer``: ``native_config.json`` (the model's config) and
``params/``, an OCDBT database (:mod:`trlx_tpu_torch.store.ocdbt`) of zarr
v2 arrays (:mod:`trlx_tpu_torch.store.zarr`), one per parameter, named by
the parameter's flax path joined with ``.``, which is the port's
``state_dict`` name (:mod:`trlx_tpu_torch.models.convert`). The port reads
and writes it itself: orbax imports JAX, and tensorstore is not on every
machine. Either package restores a store the other wrote.

CLI::

    python -m trlx_tpu_torch.checkpointing convert /path/to/hf_model out_dir \
        [--dtype bfloat16] [--seq2seq] [--override key=value ...] [--allow-random]
    python -m trlx_tpu_torch.checkpointing inspect out_dir

With a ``mesh``, :func:`restore_native` gives each rank the block of every
parameter that :func:`~trlx_tpu_torch.parallel.sharding.make_param_specs`
assigns to its coordinates, reading only the zarr chunks that overlap it.

Compression: zstd (libzstd, :mod:`trlx_tpu_torch.store.zstd`) for the
database's nodes and for the chunks, as orbax writes. Where libzstd does
not load, the writer writes both uncompressed (which orbax and tensorstore
read), and reading a zstd store raises, naming the library.
"""

import argparse
import dataclasses
import json
import os
import time
from typing import Any, Dict, Optional, Tuple

import torch

from trlx_tpu_torch.store import ocdbt, zarr
from trlx_tpu_torch.utils import logging

logger = logging.get_logger(__name__)

NATIVE_CONFIG = "native_config.json"
FORMAT_VERSION = 1
PARAMS_DIR = "params"
_HANDLER = "orbax.checkpoint._src.handlers.standard_checkpoint_handler.StandardCheckpointHandler"


def is_native_checkpoint(path: str) -> bool:
    return os.path.isdir(path) and os.path.exists(os.path.join(path, NATIVE_CONFIG))


def _dtype_name(val) -> str:
    if isinstance(val, torch.dtype):
        return str(val).replace("torch.", "")
    import numpy as np

    return str(np.dtype(val))


def _config_to_jsonable(config) -> Dict[str, Any]:
    out = {}
    for field in dataclasses.fields(config):
        val = getattr(config, field.name)
        if isinstance(val, (str, int, float, bool, type(None), list, tuple)):
            out[field.name] = list(val) if isinstance(val, tuple) else val
        else:  # dtypes
            try:
                out[field.name] = _dtype_name(val)
            except TypeError as e:
                raise TypeError(
                    f"Config field {type(config).__name__}.{field.name} "
                    f"({type(val).__name__}) is not JSON-serializable and not a "
                    f"dtype; extend _config_to_jsonable for it"
                ) from e
    return out


def _random_state(config, seq2seq: bool) -> Dict[str, torch.Tensor]:
    """The port's seed-0 initialisation of the trunk (its initializers, not
    the JAX module's bits)."""
    if seq2seq:
        from trlx_tpu_torch.models.t5 import T5LM

        return T5LM(config).init_params(0).state_dict()
    from trlx_tpu_torch.models.transformer import TransformerLM

    return TransformerLM(config).init_params(0).state_dict()


def convert_hf_to_native(
    model_path: str,
    out_dir: str,
    dtype: Optional[str] = None,
    overrides: Optional[Dict[str, Any]] = None,
    seq2seq: bool = False,
    allow_random: bool = False,
) -> str:
    """Convert a local HF checkpoint dir (or, with ``allow_random``, a preset
    name -> random init) into a native pre-converted checkpoint at
    ``out_dir``. Returns ``out_dir``.

    Missing weights raise by default (a random-init "native checkpoint"
    must not pass for a pretrained one); ``allow_random=True`` (CLI
    ``--allow-random``) opts in, for causal models only. ``dtype``
    optionally casts floating parameters at rest (``bfloat16`` halves the
    store and the restore's reads)."""
    from trlx_tpu_torch.models.hf_loading import load_pretrained, load_pretrained_seq2seq, torch_dtype

    overrides = dict(overrides or {})
    if seq2seq:
        config, state = load_pretrained_seq2seq(model_path, overrides)
        model_type = "t5"
    else:
        config, state, model_type = load_pretrained(model_path, overrides)
    if state is None:
        if seq2seq:
            raise FileNotFoundError(
                f"No local checkpoint at {model_path!r} to convert — pass a local "
                f"HF checkpoint dir (random init is not supported for seq2seq "
                f"conversion; --allow-random applies to causal models only)"
            )
        if not allow_random:
            raise FileNotFoundError(
                f"No local checkpoint at {model_path!r} to convert (HF hub names "
                f"don't resolve in a zero-egress environment — pass a local HF "
                f"checkpoint dir, or --allow-random for an explicit random init)"
            )
        logger.warning(f"No weights at {model_path!r}; converting a RANDOM init")
        state = _random_state(config, seq2seq)
    if dtype is not None:
        cast = torch_dtype(dtype)
        state = {k: v.to(cast) if v.is_floating_point() else v for k, v in state.items()}

    source = os.path.abspath(model_path) if os.path.isdir(model_path) else model_path
    save_native(out_dir, state, config, model_type, source, dtype=dtype, seq2seq=seq2seq)
    n = sum(v.numel() for v in state.values())
    logger.info(f"Converted {model_path} ({model_type}, {n / 1e6:.1f}M params) -> {out_dir}")
    return os.path.abspath(out_dir)


def save_native(out_dir: str, state: Dict[str, torch.Tensor], config, model_type: str, source: str,
                dtype: Optional[str] = None, seq2seq: bool = False, compress: Optional[bool] = None) -> str:
    """Write a trunk ``state_dict`` and its config as a native store at
    ``out_dir`` (:func:`convert_hf_to_native`'s second half: weights already
    in memory). ``source`` and ``dtype`` are recorded as given."""
    out_dir = os.path.abspath(out_dir)
    os.makedirs(out_dir, exist_ok=True)
    save_params(os.path.join(out_dir, PARAMS_DIR), state, compress)
    meta = {
        "format_version": FORMAT_VERSION,
        "model_type": model_type,
        "seq2seq": seq2seq,
        "source": source,
        "dtype": dtype,
        "config": _config_to_jsonable(config),
    }
    with open(os.path.join(out_dir, NATIVE_CONFIG), "w") as f:
        json.dump(meta, f, indent=1)
    return out_dir


def save_params(path: str, state: Dict[str, torch.Tensor], compress: Optional[bool] = None) -> None:
    """Write a ``state_dict`` as the orbax ``StandardCheckpointer`` layout:
    the OCDBT database of zarr arrays (one chunk each) and orbax's metadata
    files, as it writes them for a tree of host arrays."""
    os.makedirs(path, exist_ok=True)
    t0 = time.time_ns()
    items = {}
    for name, tensor in state.items():
        items.update(zarr.encode_array(name, tensor, compress))
    ocdbt.write_database(path, items, compress)
    tree = {}
    for name in sorted(state, key=lambda n: tuple(n.split("."))):
        keys = tuple(name.split("."))
        tree[str(keys)] = {"key_metadata": [{"key": k, "key_type": 2} for k in keys],
                           "value_metadata": {"value_type": "np.ndarray", "skip_deserialize": False}}
    with open(os.path.join(path, "_METADATA"), "w") as f:
        json.dump({"tree_metadata": tree, "use_ocdbt": True, "use_zarr3": False,
                   "store_array_data_equal_to_fill_value": True, "custom_metadata": None}, f)
    with open(os.path.join(path, "_CHECKPOINT_METADATA"), "w") as f:
        json.dump({"item_handlers": _HANDLER, "metrics": {}, "performance_metrics": {},
                   "init_timestamp_nsecs": t0, "commit_timestamp_nsecs": time.time_ns(), "custom_metadata": {}}, f)


def load_native_config(path: str) -> Dict[str, Any]:
    with open(os.path.join(path, NATIVE_CONFIG)) as f:
        return json.load(f)


def _rebuild_config(meta: Dict[str, Any], overrides: Optional[Dict[str, Any]]):
    """Rebuild a TransformerConfig / T5Config from the stored JSON. Overrides
    apply through ``replace`` with the strictness of every other load path
    (unknown keys raise); stored keys this code does not know are dropped
    (older formats only: newer ones are refused in :func:`restore_native`)."""
    from trlx_tpu_torch.models.hf_loading import _DTYPE_FIELDS, torch_dtype

    cfg = dict(meta["config"])
    for key in ("param_dtype", "compute_dtype"):
        if key in cfg:
            cfg[key] = torch_dtype(cfg[key])
    if meta.get("seq2seq"):
        from trlx_tpu_torch.models.t5 import T5Config as ConfigCls
    else:
        from trlx_tpu_torch.models.transformer import TransformerConfig as ConfigCls
    fields = {f.name: f for f in dataclasses.fields(ConfigCls)}
    names = set(fields)
    cfg = {k: v for k, v in cfg.items() if k in names}
    # JSON stores tuples as lists; tuple-defaulted fields (lora_targets) come back as tuples
    for k, v in cfg.items():
        if isinstance(v, list) and isinstance(fields[k].default, tuple):
            cfg[k] = tuple(v)
    config = ConfigCls(**cfg)
    if overrides:
        unknown = sorted(set(overrides) - names)
        if unknown:
            raise TypeError(
                f"Unknown config override(s) {unknown} for native checkpoint "
                f"({ConfigCls.__name__})"
            )
        overrides = {k: torch_dtype(v) if k in _DTYPE_FIELDS else v for k, v in overrides.items()}
        config = config.replace(**overrides)
    return config


class ParamsStore:
    """The arrays of a ``params/`` directory (the OCDBT database orbax
    writes). :meth:`read` returns a region of one array; ``bytes_read``
    counts the stored chunk bytes read so far."""

    def __init__(self, path: str):
        self.db = ocdbt.Database(path)
        self.names = sorted(k[:-len(zarr.ZARRAY) - 1] for k in self.db.keys() if k.endswith("/" + zarr.ZARRAY))
        self.meta = {n: zarr.parse_metadata(self._get(f"{n}/{zarr.ZARRAY}"), n) for n in self.names}
        self.bytes_read = 0

    def _get(self, key: str) -> Optional[bytes]:
        return self.db.get(key) if key in self.db else None

    def shape(self, name: str) -> Tuple[int, ...]:
        return tuple(self.meta[name]["shape"])

    def read(self, name: str, box=None) -> torch.Tensor:
        out, n = zarr.read_region(self._get, name, self.meta[name], box)
        self.bytes_read += n
        return out


def shard_box(shape, spec, mesh) -> list:
    """``[(start, stop)]`` per dim of the block of a ``shape`` array that
    ``spec`` gives this rank's coordinates (the block
    :func:`~trlx_tpu_torch.parallel.sharding.shard_tensor` cuts)."""
    from trlx_tpu_torch.parallel.sharding import _entry_axes

    box = [[0, s] for s in shape]
    for i, entry in enumerate(spec):
        for a in _entry_axes(entry):
            n = (box[i][1] - box[i][0]) // mesh.shape[a]
            box[i][0] += mesh.coords[a] * n
            box[i][1] = box[i][0] + n
    return [tuple(b) for b in box]


def restore_native(
    path: str,
    overrides: Optional[Dict[str, Any]] = None,
    mesh=None,
    expect_seq2seq: Optional[bool] = None,
    device="cpu",
    stats: Optional[Dict[str, Any]] = None,
) -> Tuple[Any, Dict[str, torch.Tensor], str]:
    """Restore ``(config, state_dict, model_type)`` from a converted
    checkpoint, the tensors on ``device`` in their stored dtype.

    With ``mesh`` (a :class:`~trlx_tpu_torch.parallel.mesh.Mesh`) each
    tensor is this rank's block under the partition rules, and only the
    chunks overlapping it are read. ``stats``, when given, receives
    ``bytes_read`` (stored chunk bytes) and ``seconds``."""
    t0 = time.perf_counter()
    meta = load_native_config(path)
    stored_version = int(meta.get("format_version", 0))
    if stored_version > FORMAT_VERSION:
        raise ValueError(
            f"Native checkpoint at {path!r} has format_version={stored_version}, "
            f"newer than this code's {FORMAT_VERSION}; restoring would silently "
            f"drop fields — upgrade trlx_tpu_torch instead"
        )
    if expect_seq2seq is not None and bool(meta.get("seq2seq")) != expect_seq2seq:
        stored = "seq2seq" if meta.get("seq2seq") else "causal"
        wanted = "seq2seq" if expect_seq2seq else "causal"
        raise ValueError(
            f"Native checkpoint at {path!r} is {stored} but a {wanted} model was "
            f"requested (model_arch_type / --seq2seq mismatch)"
        )
    config = _rebuild_config(meta, overrides)
    store = ParamsStore(os.path.join(os.path.abspath(path), PARAMS_DIR))
    specs = None
    if mesh is not None:
        from trlx_tpu_torch.parallel.sharding import make_param_specs

        specs = make_param_specs({n: store.shape(n) for n in store.names}, mesh)
    state = {}
    for name in store.names:
        box = shard_box(store.shape(name), specs[name], mesh) if specs is not None else None
        state[name] = store.read(name, box).to(device)
    if stats is not None:
        stats.update(bytes_read=store.bytes_read, seconds=time.perf_counter() - t0)
    return config, state, meta["model_type"]


def store_bytes(path: str) -> int:
    """The bytes of every file under a store."""
    return sum(os.path.getsize(os.path.join(root, f)) for root, _, files in os.walk(path) for f in files)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = parser.add_subparsers(dest="cmd", required=True)
    conv = sub.add_parser("convert", help="HF torch checkpoint dir -> native store")
    conv.add_argument("model_path")
    conv.add_argument("out_dir")
    conv.add_argument("--dtype", default=None, help="cast floating params (e.g. bfloat16)")
    conv.add_argument("--seq2seq", action="store_true")
    conv.add_argument("--override", action="append", default=[], metavar="KEY=VALUE")
    conv.add_argument(
        "--allow-random", action="store_true",
        help="permit converting a random init when no weights exist at model_path",
    )
    insp = sub.add_parser("inspect", help="print a native checkpoint's metadata")
    insp.add_argument("path")
    args = parser.parse_args(argv)

    if args.cmd == "convert":
        overrides = {}
        for item in args.override:
            key, _, val = item.partition("=")
            try:
                overrides[key] = json.loads(val)
            except json.JSONDecodeError:
                overrides[key] = val
        convert_hf_to_native(
            args.model_path, args.out_dir, dtype=args.dtype,
            overrides=overrides, seq2seq=args.seq2seq, allow_random=args.allow_random,
        )
    else:
        meta = load_native_config(args.path)
        cfg = meta.pop("config")
        print(json.dumps(meta, indent=1))
        print(json.dumps(cfg, indent=1))


if __name__ == "__main__":
    main()
