"""Atomic, asynchronous checkpointing (counterpart of
``trlx_tpu/resilience/checkpoint.py``).

**The atomicity protocol** (the reference's, unchanged). A checkpoint
directory is *committed* iff it contains the ``_COMMITTED`` sentinel file.
Writers build the full payload in a sibling ``<name>.tmp`` directory,
``os.replace`` it to its final name, then write the sentinel and fsync the
parent directory. A crash or preemption at any point therefore leaves one of
exactly three states — nothing, an orphaned ``.tmp`` dir, or a final-named
dir without the sentinel — all of which
:func:`trlx_tpu_torch.resilience.resume.find_latest_committed` recognizes as
torn and skips. A sentinel is never present over partial bytes.

**The payload** is the port's own: one ``torch.save`` file
(:data:`PAYLOAD_FILE`, the parameters, the optimizer and the scheduler) in
place of the reference's orbax trees, beside ``state.json`` (counters, RNG
streams, the prompt-stream position).

**Host snapshots.** ``model.state_dict()`` and ``optimizer.state_dict()``
hand back *references* to the live tensors, and ``optimizer.step()``
changes those in place. A writer thread that serialized them while the
learner stepped on would write a checkpoint that is part step k and part
step k+1, and nothing would fail. :func:`host_snapshot` therefore copies
every tensor to the host before the writer sees it: CPU tensors are cloned,
CUDA tensors copied into fresh pinned buffers with ``non_blocking=True``
behind one recorded ``torch.cuda.Event`` that the commit waits on. The
copies are queued on the learner's stream, so the next step's in-place
updates run after them in stream order and the learner itself never waits.

**The async writer.** :class:`AsyncCheckpointWriter` runs serialize → fsync
→ rename → sentinel on a background thread; the learner only blocks when a
*prior* write is still in flight (one write in flight at a time keeps peak
host memory to one snapshot and makes commit order equal request order).
The writer thread beats the stall watchdog while committing, and errors are
re-raised on the learner thread at the next ``save()``/``wait()``.
"""

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional

from trlx_tpu_torch.obs import span, watchdog
from trlx_tpu_torch.resilience.chaos import chaos
from trlx_tpu_torch.utils import logging
from trlx_tpu_torch.utils.metrics import gauges

logger = logging.get_logger(__name__)

COMMITTED_SENTINEL = "_COMMITTED"
TMP_SUFFIX = ".tmp"
STATE_FILE = "state.json"
PAYLOAD_FILE = "trainer.pt"
WRITER_HEARTBEAT = "checkpoint-writer"


def _fsync_dir(path: str) -> None:
    """fsync a directory so renames/creates inside it survive power loss;
    best-effort on filesystems that reject directory fds."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def is_committed(path: str) -> bool:
    """True iff ``path`` is a checkpoint directory with the commit sentinel."""
    return os.path.isdir(path) and os.path.exists(os.path.join(path, COMMITTED_SENTINEL))


def mark_committed(path: str) -> None:
    """Write the commit sentinel (the LAST step of any checkpoint write)."""
    sentinel = os.path.join(path, COMMITTED_SENTINEL)
    with open(sentinel, "w") as f:
        f.write(f"committed {time.time():.3f}\n")
        f.flush()
        os.fsync(f.fileno())
    _fsync_dir(path)


def write_json_atomic(path: str, obj: Any) -> None:
    """Write JSON via tmp-file + fsync + rename: readers see old or new, never torn."""
    tmp = path + TMP_SUFFIX
    with open(tmp, "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path) or ".")


def write_payload(directory: str, payload: Dict[str, Any]) -> None:
    """``torch.save`` the payload to ``directory/trainer.pt`` (through a
    temporary name, fsynced), leaving the file whole or absent."""
    import torch

    path = os.path.join(directory, PAYLOAD_FILE)
    torch.save(payload, path + TMP_SUFFIX)
    with open(path + TMP_SUFFIX, "rb") as f:
        os.fsync(f.fileno())
    os.replace(path + TMP_SUFFIX, path)


def write_checkpoint(path: str, payload: Dict[str, Any], state: Dict[str, Any]) -> str:
    """Commit ``payload`` (host objects, one ``torch.save`` file) and
    ``state`` (JSON) to ``path`` under the atomicity protocol in the module
    docstring. Runs on the caller's thread; the async writer calls this from
    its worker."""
    path = os.path.abspath(path)
    tmp = path + TMP_SUFFIX
    if os.path.exists(tmp):  # leftover from a previous crash mid-write
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    try:
        chaos.fail_if_armed("checkpoint", detail=path)
        write_payload(tmp, payload)
        write_json_atomic(os.path.join(tmp, STATE_FILE), state)
    except BaseException:
        # the sentinel was never written and the final name never created:
        # a failed write leaves no dir a resume scan could mistake for real
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    if os.path.exists(path):  # re-saving the same step (e.g. best_checkpoint)
        shutil.rmtree(path)
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path))
    mark_committed(path)
    return path


def host_snapshot(obj: Any):
    """``(copy, ready)``: ``obj`` (nested dicts, lists and tuples of tensors
    and plain values, as ``state_dict()`` returns) with every tensor copied
    to the host, so that no later in-place update reaches the copy. CUDA
    tensors go to fresh pinned buffers with ``non_blocking=True`` and
    ``ready`` is a ``torch.cuda.Event`` recorded after the last copy (read
    the copy only after ``ready.synchronize()``); with no CUDA tensor,
    ``ready`` is None and the copy is complete on return."""
    import torch

    cuda = []

    def copy(x):
        if isinstance(x, torch.Tensor):
            x = x.detach()
            if x.is_cuda:
                buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                buf.copy_(x, non_blocking=True)
                cuda.append(x.device)
                return buf
            return x.clone()
        if isinstance(x, dict):
            return type(x)((k, copy(v)) for k, v in x.items())
        if isinstance(x, (list, tuple)):
            return type(x)(copy(v) for v in x)
        return x

    out = copy(obj)
    ready = None
    if cuda:
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(cuda[0]))
    return out, ready


def gc_checkpoints(
    checkpoint_dir: str,
    keep_last: int,
    protected: Optional[List[str]] = None,
    prefix: str = "checkpoint_",
) -> List[str]:
    """Delete all but the newest ``keep_last`` step checkpoints under
    ``checkpoint_dir``. Only committed, ``prefix``-named dirs are candidates:
    ``.tmp`` leftovers, uncommitted dirs, and ``protected`` names
    (``best_checkpoint``, ``hf_model``) are never touched — an uncommitted dir
    may be a write in flight. Returns the deleted paths."""
    from trlx_tpu_torch.resilience.resume import checkpoint_step

    protected = set(protected or [])
    if keep_last <= 0 or not os.path.isdir(checkpoint_dir):
        return []
    candidates = []
    for name in os.listdir(checkpoint_dir):
        if not name.startswith(prefix) or name.endswith(TMP_SUFFIX) or name in protected:
            continue
        path = os.path.join(checkpoint_dir, name)
        step = checkpoint_step(name, prefix)
        if step is None or not is_committed(path):
            continue
        candidates.append((step, path))
    candidates.sort()
    deleted = []
    for _, path in candidates[:-keep_last]:
        shutil.rmtree(path, ignore_errors=True)
        deleted.append(path)
        logger.info(f"Retention: deleted old checkpoint {path}")
    return deleted


class AsyncCheckpointWriter:
    """One-in-flight background checkpoint committer (see module docstring)."""

    def __init__(self, keep_last: int = 0, protected: Optional[List[str]] = None):
        self.keep_last = keep_last
        self.protected = list(protected or [])
        # guards the writer handle and its results: the commit thread writes
        # _error/_last_committed while the learner thread polls in_flight/
        # last_committed between saves
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._last_committed: Optional[str] = None

    @property
    def in_flight(self) -> bool:
        with self._lock:
            thread = self._thread
        return thread is not None and thread.is_alive()

    @property
    def last_committed(self) -> Optional[str]:
        with self._lock:
            return self._last_committed

    def save(
        self,
        path: str,
        payload: Dict[str, Any],
        state: Dict[str, Any],
        block: bool = False,
        ready=None,
    ) -> None:
        """Queue one commit. Blocks only while a *prior* write is in flight
        (or entirely, with ``block=True`` — the emergency-checkpoint path).
        ``payload`` must be a host snapshot (:func:`host_snapshot`), never
        live tensors the learner goes on updating; ``ready`` is the
        snapshot's event, which the commit waits on before serializing."""
        self.wait()  # also re-raises a previous write's error on this thread

        def commit():
            t0 = time.monotonic()
            try:
                watchdog.beat(WRITER_HEARTBEAT)
                with span("checkpoint_commit"):
                    if ready is not None:
                        ready.synchronize()
                    write_checkpoint(path, payload, state)
                if self.keep_last:
                    gc_checkpoints(os.path.dirname(path), self.keep_last, self.protected)
                with self._lock:
                    self._last_committed = os.path.abspath(path)
                gauges.inc("resilience/ckpt_committed")
                gauges.set("resilience/ckpt_commit_s", time.monotonic() - t0)
                logger.info(f"Committed checkpoint {path} in {time.monotonic() - t0:.2f}s")
            except BaseException as e:
                with self._lock:
                    self._error = e
                logger.error(f"Checkpoint commit to {path} FAILED: {e}")
            finally:
                gauges.set("resilience/ckpt_inflight", 0.0)
                # no false posthumous stall report from an idle writer
                watchdog.unregister(WRITER_HEARTBEAT)

        gauges.set("resilience/ckpt_inflight", 1.0)
        thread = threading.Thread(target=commit, name="ckpt-writer", daemon=True)
        with self._lock:
            self._thread = thread
        thread.start()
        if block:
            self.wait()

    def wait(self, timeout: Optional[float] = None) -> None:
        """Join the in-flight write (if any); re-raise its error here."""
        with self._lock:
            thread = self._thread
        if thread is not None:
            # join OUTSIDE the lock: a commit in flight holds the disk for the
            # full serialize+fsync and in_flight/last_committed must stay live
            thread.join(timeout)
            if thread.is_alive():
                raise TimeoutError(f"checkpoint write still in flight after {timeout}s")
        with self._lock:
            if self._thread is thread:  # re-check: a newer save() may have swapped
                self._thread = None
            err, self._error = self._error, None
        if err is not None:
            raise RuntimeError("async checkpoint write failed") from err

    def close(self) -> None:
        """Flush the in-flight write; errors are logged, not raised (teardown)."""
        try:
            self.wait()
        except Exception as e:
            logger.error(f"async checkpoint writer: error during close: {e}")
