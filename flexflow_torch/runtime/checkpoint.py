"""Checkpoint and resume: the port of ``flexflow_tpu/runtime/
checkpoint.py``, in a format of the port's own (torch and the standard
library; no orbax).

**Layout.**  One directory per step under the root, named by the step
(``<root>/12``), one subdirectory per item under the JAX package's item
names (``params``, ``opt_state``, ``state``), each holding
``tensors.pt``: a ``torch.save`` of a flat ``{key path: CPU tensor}``
map (``"fc1/kernel"``, ``"m/fc1/kernel"``, ``"t"``), read back with
``weights_only=True``.  An item with no tensor (SGD without momentum, a
model without op state) is left out and restores to its template.

**Commits.**  A step is written into a staging directory
(``<step>.tmp-<pid>-<n>``, never a plain integer, so step discovery
skips it) and made visible by ONE ``os.rename``.  A torn step (a crash
mid-delete, bit rot: its ``params`` item missing or unreadable) is
skipped by latest-step restore, which falls back to the step before and
emits ``ckpt_torn``; when every step is unreadable it raises
:class:`TornCheckpointError`, never ``FileNotFoundError`` (which means
"no checkpoint: start fresh").  Replacing an existing step stages the
new snapshot as ``<step>.force-tmp`` (itself committed by a rename),
then retires the old directory and promotes the staged one, so some
committed snapshot of the step is on disk at every instant;
``_recover_pending_force`` finishes a swap a dead process left when the
next writing manager is built, and removes the staging of writers that
are no longer alive (the pid is in the staging name): a live writer's
in-flight staging is never touched.  A ``read_only`` manager (a server
restoring a trainer's snapshots) never writes, recovers or deletes, so
it may point at the directory of a trainer that is still running.

**Restore into existing tensors.**  ``restore(templates=...)`` checks
each saved item's key set, shapes and dtypes against the template and
copies every tensor INTO the template's own tensor (``copy_``): a
rolled-back run then replays the CUDA graph it captured on those
tensors (``runtime/graphs.py`` refuses others).  A key mismatch raises
``ValueError`` (a changed model is a programmer error, never a reason
to fall back to an older step).  A ``None`` template restores the saved
item as a new tree of CPU tensors (a server reads a training snapshot's
optimizer state that way and drops it).

**Async saves** (the default; ``async_save=False`` is ``--sync-ckpt``):
``save`` copies every tensor to host memory before it returns (a
device-to-host copy into host buffers, pinned for a CUDA source, and a
wait on it), because the next step overwrites the same storage in
place; only the file writes go to a background thread.  A write that
failed there is raised at the next ``save``, ``wait_until_finished``,
``restore`` or ``close``, never logged and dropped.

One writer: ``is_primary`` is rank 0 of an initialised
``torch.distributed`` world that is not ``read_only``, and True
otherwise; only it writes.

**Under a world of ranks** the trainer binds the executor's
``layout`` (``Executor.snapshot_layout``; the manager itself knows no
strategy), and the format stays the same: whole tensors.  ``save`` has
every rank gather its blocks into whole tensors (``layout.full``, a
collective, on the caller's thread) before the primary check; only rank
0 copies them to the host and writes.  ``restore`` has rank 0 flush its
pending write and choose the step (the newest readable one), which is
broadcast, so every rank loads the same step; each rank copies its
block of every whole tensor (``layout.cut``) into its template, the
key, shape and dtype checks made against the whole shape.  So a
snapshot written under one strategy or number of ranks restores under
any other, ZeRO-1's moments with ZeRO off included.
"""

from __future__ import annotations

import itertools
import logging
import os
import re
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from flexflow_torch.runtime import telemetry as _telemetry

_log = logging.getLogger("ff.checkpoint")

#: Suffix of the crash-safe force-replace staging snapshot.
FORCE_TMP_SUFFIX = ".force-tmp"

#: The file of one item.
ITEM_FILE = "tensors.pt"

#: The items of a snapshot, in the JAX package's names.
ITEMS = ("params", "opt_state", "state")

_FORCE_TMP_RE = re.compile(r"^(\d+)\.force-tmp$")
_STAGING_RE = re.compile(r"\.tmp-(\d+)(?:-\d+)?$")
_STAGING = itertools.count()


class TornCheckpointError(OSError):
    """A step directory exists but is not a complete snapshot."""


def flatten(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """``{key path: tensor}`` of a tree of dicts, lists and tuples (key
    paths joined by ``/``); other leaves (None, numbers) are skipped."""
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    out: Dict[str, torch.Tensor] = {}
    if isinstance(tree, dict):
        items = ((str(k), v) for k, v in tree.items())
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return out
    for k, v in items:
        out.update(flatten(v, f"{prefix}/{k}" if prefix else k))
    return out


def unflatten(flat: Dict[str, torch.Tensor]):
    """The nested dicts of a ``{key path: tensor}`` map."""
    out: Dict[str, Any] = {}
    for path, t in flat.items():
        node = out
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = t
    return out


def _is_primary() -> bool:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank() == 0
    return True


def _alive(pid: int) -> bool:
    """Whether process ``pid`` exists (this process counts)."""
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


class CheckpointManager:
    """Save and restore ``(params, opt_state, state, step)`` snapshots.

    Usage::

        ckpt = CheckpointManager("/path/ckpts", max_to_keep=3)
        ckpt.save(step, params, opt_state, state)
        ...
        step, params, opt_state, state = ckpt.restore(
            templates=(params0, opt0, state0))  # from Executor.init()

    ``save_interval_steps`` gates non-forced saves (a step must be a
    multiple of it, or the first); ``max_to_keep`` steps are kept, the
    oldest deleted after each commit.  ``read_only`` makes a reader: it
    saves nothing and leaves the directory as it finds it."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 save_interval_steps: int = 1, async_save: bool = False,
                 read_only: bool = False):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = max(1, int(save_interval_steps))
        self.async_save = async_save
        self.is_primary = _is_primary() and not read_only
        self._writer: Optional[threading.Thread] = None
        self._write_error: Optional[BaseException] = None
        self._pinned: Dict[Tuple[str, str], torch.Tensor] = {}
        #: The executor's snapshot layout under a world of ranks (see the
        #: module docstring); None: the tensors are whole already.
        self.layout = None
        if self.is_primary:
            os.makedirs(self.directory, exist_ok=True)
            self._recover_pending_force()

    # -- crash recovery ---------------------------------------------------

    def _recover_pending_force(self) -> None:
        """Finish force-replace swaps a crash interrupted, and remove the
        staging of dead writers (a live one's is its write in flight).
        A committed ``<step>.force-tmp`` IS the newest snapshot of that
        step (it is renamed into existence only when whole): what remains
        of the old step is retired and the staged one promoted."""
        for name in sorted(os.listdir(self.directory)):
            path = os.path.join(self.directory, name)
            staging = _STAGING_RE.search(name)
            if staging:
                if not _alive(int(staging.group(1))):
                    _log.warning("removing aborted checkpoint staging %s",
                                 name)
                    shutil.rmtree(path, ignore_errors=True)
                continue
            m = _FORCE_TMP_RE.match(name)
            if not m:
                continue
            final = os.path.join(self.directory, m.group(1))
            _log.warning("completing interrupted force-replace of step %s",
                         m.group(1))
            if os.path.lexists(final):
                shutil.rmtree(final)
            os.rename(path, final)

    # -- write ------------------------------------------------------------

    def _host_copy(self, item: str, flat: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
        """Every tensor of ``flat`` in host memory, copied now: CUDA
        tensors into pinned buffers (reused across saves: the previous
        write has finished by the time a save reaches here), then one
        wait for the copies; CPU tensors cloned."""
        out: Dict[str, torch.Tensor] = {}
        cuda = False
        for k, t in flat.items():
            t = t.detach()
            if t.device.type == "cuda":
                buf = self._pinned.get((item, k))
                if buf is None or buf.shape != t.shape or \
                        buf.dtype != t.dtype:
                    buf = torch.empty(t.shape, dtype=t.dtype,
                                      pin_memory=True)
                    self._pinned[(item, k)] = buf
                buf.copy_(t, non_blocking=True)
                out[k] = buf
                cuda = True
            else:
                out[k] = t.clone()
        if cuda:
            torch.cuda.synchronize()
        return out

    def _whole(self, params, opt_state, state) -> Dict[str, Dict]:
        """``{item: flat map of whole tensors}``, items without a tensor
        left out; under a layout every rank gathers here."""
        items = {}
        for name, tree in zip(ITEMS, (params, opt_state, state)):
            flat = flatten(tree)
            if flat or name == "params":
                items[name] = flat if self.layout is None else \
                    self.layout.full(name, flat)
        return items

    def _items(self, params, opt_state, state) -> Dict[str, Dict]:
        """``{item: flat host map}``, items without a tensor left out."""
        return {name: self._host_copy(name, flat) for name, flat in
                self._whole(params, opt_state, state).items()}

    def _write(self, dest: str, items: Dict[str, Dict]) -> None:
        """Write ``items`` into a staging directory, then rename it to
        ``dest``: ``dest`` exists only when whole."""
        tmp = f"{dest}.tmp-{os.getpid()}-{next(_STAGING)}"
        try:
            os.makedirs(tmp)
            for name, flat in items.items():
                os.makedirs(os.path.join(tmp, name))
                torch.save(flat, os.path.join(tmp, name, ITEM_FILE))
            os.rename(tmp, dest)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise

    def save(self, step: int, params, opt_state, state,
             force: bool = False) -> bool:
        """Persist one snapshot.  ``force`` skips the interval gate and,
        when the step exists, replaces it crash-safely (a run resumed from
        an older step may rightly save a step again with other values).
        Emits ``ckpt_save`` with ``io_s``, the time the caller was held
        (for an async save: the host copy, not the disk write)."""
        t0 = time.perf_counter()
        saved = self._save(int(step), params, opt_state, state, force)
        _telemetry.current().emit(
            "ckpt_save", step=int(step),
            io_s=round(time.perf_counter() - t0, 6),
            saved=bool(saved), force=bool(force),
            **{"async": self.async_save})
        return saved

    def _should_save(self, step: int) -> bool:
        latest = self.latest_step()
        if latest is not None and latest >= step:
            return False
        return latest is None or step % self.save_interval_steps == 0

    def _save(self, step: int, params, opt_state, state, force: bool) -> bool:
        self.wait_until_finished()  # one write at a time; raises its error
        whole = self._whole(params, opt_state, state) \
            if self.layout is not None else None  # every rank gathers
        if not self.is_primary:
            return False

        def items():
            if whole is None:
                return self._items(params, opt_state, state)
            return {name: self._host_copy(name, flat)
                    for name, flat in whole.items()}

        if step in self.all_steps():
            torn = not self._readable(step)
            if not (force or torn):
                _log.warning("skipping save: step %d already exists", step)
                return False
            if torn and not force:
                _log.warning("step %d exists but is torn; replacing it",
                             step)
            tmp = self._write_force_tmp(step, items())
            self._promote_force_tmp(step, tmp)
            return True
        if not force and not self._should_save(step):
            return False
        items = items()
        dest = os.path.join(self.directory, str(step))
        if self.async_save:
            self._writer = threading.Thread(
                target=self._background_write, args=(dest, items),
                name="ff-ckpt-writer", daemon=True)
            self._writer.start()
        else:
            self._write(dest, items)
            self._retire()
        return True

    def _background_write(self, dest: str, items) -> None:
        try:
            self._write(dest, items)
            self._retire()
        except BaseException as e:  # raised at the next call
            self._write_error = e

    def _write_force_tmp(self, step: int, items) -> str:
        """Phase 1 of a replace: the new snapshot committed as
        ``<step>.force-tmp`` beside the live one."""
        tmp = os.path.join(self.directory, f"{step}{FORCE_TMP_SUFFIX}")
        if os.path.lexists(tmp):
            shutil.rmtree(tmp)  # stale staging of an abandoned swap
        self._write(tmp, items)
        return tmp

    def _promote_force_tmp(self, step: int, tmp: str) -> None:
        """Phases 2 and 3: retire the old snapshot of ``step``, promote
        the staged one."""
        final = os.path.join(self.directory, str(step))
        if os.path.lexists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)

    def _retire(self) -> None:
        """Delete the oldest steps beyond ``max_to_keep``."""
        if not self.max_to_keep:
            return
        for s in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(s)),
                          ignore_errors=True)

    def wait_until_finished(self) -> None:
        """The flush fence: wait for the pending write; raise its error."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._write_error is not None:
            err, self._write_error = self._write_error, None
            raise RuntimeError(f"an asynchronous checkpoint write failed: "
                               f"{type(err).__name__}: {err}") from err

    def reload(self) -> None:
        """The JAX manager's metadata resync.  This manager caches
        nothing, so it only waits for the pending write."""
        self.wait_until_finished()

    # -- read -------------------------------------------------------------

    def all_steps(self) -> List[int]:
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and
                      os.path.isdir(os.path.join(self.directory, n)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def has_step(self, step: int) -> bool:
        """Whether ``step`` is committed, its pending write flushed first;
        under a layout rank 0's answer, the same on every rank."""
        self.wait_until_finished()
        found = step in self.all_steps()
        if self.layout is None:
            return found
        return bool(self.layout.broadcast_int(int(found)))

    def _item_path(self, step: int, item: str) -> str:
        return os.path.join(self.directory, str(step), item, ITEM_FILE)

    def _readable(self, step: int) -> bool:
        return os.path.isfile(self._item_path(step, "params"))

    def restore(self, templates: Tuple[Any, Any, Any],
                step: Optional[int] = None):
        """Restore ``(step, params, opt_state, state)`` into
        ``templates`` (``Executor.init()``'s trees: the saved values are
        copied into their tensors).  ``step=None`` restores the latest
        readable step, skipping torn ones; an explicit step restores that
        step or raises.  Emits ``ckpt_restore`` (I/O seconds, the flush
        included) and ``ckpt_torn`` per skipped step."""
        t0 = time.perf_counter()
        out = self._restore(templates, step)
        _telemetry.current().emit(
            "ckpt_restore", step=int(out[0]),
            io_s=round(time.perf_counter() - t0, 6))
        return out

    def _restore(self, templates, step):
        self.wait_until_finished()  # async saves must be visible
        if step is not None:
            return self._restore_step(int(step), templates)
        if self.layout is None:
            chosen, loaded = self._choose()
            return self._restore_step(chosen, templates, loaded)
        # Rank 0 chooses; every rank loads the step it chose.
        chosen, loaded, err = -1, None, None
        if self.layout.rank == 0:
            try:
                chosen, loaded = self._choose()
            except TornCheckpointError as e:
                chosen, err = -2, e
            except FileNotFoundError as e:
                err = e
        chosen = self.layout.broadcast_int(chosen)
        if chosen == -1:
            raise err or FileNotFoundError(
                f"no checkpoint found under {self.directory}")
        if chosen == -2:
            raise err or TornCheckpointError(
                f"no restorable checkpoint under {self.directory}")
        return self._restore_step(chosen, templates, loaded)

    def _choose(self):
        """``(step, loaded items)`` of the newest readable step; a torn
        step is skipped (``ckpt_torn``).  Raises FileNotFoundError with
        no step, TornCheckpointError when every step is torn."""
        steps = self.all_steps()[::-1]
        if not steps:
            raise FileNotFoundError(
                f"no checkpoint found under {self.directory}")
        last_err: Optional[Exception] = None
        for s in steps:
            try:
                return s, self._load_step(s)
            # Narrow on purpose: a ValueError is a template mismatch and
            # must surface, never fall back to an older step.
            except (TornCheckpointError, FileNotFoundError, OSError) as e:
                _log.warning("checkpoint step %d unreadable (%s: %s); "
                             "falling back to the previous step", s,
                             type(e).__name__, e)
                _telemetry.current().emit(
                    "ckpt_torn", step=int(s),
                    error=f"{type(e).__name__}: {e}")
                last_err = e
        raise TornCheckpointError(
            f"no restorable checkpoint under {self.directory} "
            f"({len(steps)} step dirs present, all unreadable)"
        ) from last_err

    def _load(self, step: int, item: str) -> Optional[Dict[str, torch.Tensor]]:
        path = self._item_path(step, item)
        if not os.path.exists(path):
            if item == "params":
                raise TornCheckpointError(
                    f"step {step}: no params item (torn snapshot)")
            return None
        try:
            flat = torch.load(path, map_location="cpu", weights_only=True)
        except (EOFError, RuntimeError, ValueError) as e:
            raise TornCheckpointError(
                f"step {step}: item {item} unreadable: {e}") from e
        if not isinstance(flat, dict):
            raise TornCheckpointError(f"step {step}: item {item} is not a "
                                      f"tensor map")
        return flat

    def _into(self, item: str, saved: Optional[Dict[str, torch.Tensor]],
              template):
        """``saved`` copied into ``template``'s tensors (under a layout the
        rank's block of each); the template is returned.  No saved item:
        the template (it held no tensor)."""
        want = flatten(template)
        if saved is None:
            if want:
                raise ValueError(
                    f"checkpoint {item}: key mismatch: the snapshot has no "
                    f"{item}, the template has {sorted(want)[:4]}...")
            return template
        if template is None:
            return unflatten(saved)
        if set(saved) != set(want):
            missing = sorted(set(want) - set(saved))
            extra = sorted(set(saved) - set(want))
            raise ValueError(
                f"checkpoint {item}: key mismatch: the template has "
                f"{missing[:4]} the snapshot lacks, the snapshot has "
                f"{extra[:4]} the template lacks")
        lay = self.layout
        for k, dst in want.items():
            src = saved[k]
            shape = tuple(dst.shape) if lay is None else \
                lay.full_shape(item, k, dst)
            if tuple(src.shape) != shape or src.dtype != dst.dtype:
                raise ValueError(
                    f"checkpoint {item}/{k}: saved {tuple(src.shape)} "
                    f"{src.dtype}, template {shape} {dst.dtype}")
        with torch.no_grad():
            for k, dst in want.items():
                dst.copy_(saved[k] if lay is None else
                          lay.cut(item, k, saved[k]))
        return template

    def _load_step(self, step: int):
        return {item: self._load(step, item) for item in ITEMS}

    def _restore_step(self, step: int, templates, loaded=None):
        """``step`` restored into ``templates`` from its ``loaded`` items
        (None: read them now)."""
        t_params, t_opt, t_state = templates
        loaded = loaded or self._load_step(step)
        return (step,
                self._into("params", loaded["params"], t_params),
                self._into("opt_state", loaded["opt_state"], t_opt),
                self._into("state", loaded["state"], t_state))

    def close(self) -> None:
        self.wait_until_finished()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
