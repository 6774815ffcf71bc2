"""Checkpoint save / load, crash-safe by write discipline — counterpart of
``deepspeed_tpu/checkpoint/saving.py`` (the reference's
``engine.save_checkpoint`` ``runtime/engine.py:3218``, ``load_checkpoint``
:2872, the ``latest`` tag file :3430).

Layout (JAX's):

    <dir>/latest               the newest published tag
    <dir>/<tag>/state/         one file per leaf of the training state
                               (checkpoint/engine.py) and manifest.json
    <dir>/<tag>/meta.json      steps, LR scheduler, client_state, data
                               position, sha256 of every other file

The state's leaves are logical (unsharded) tensors named by their tree
path: ``step``, ``params/...`` (the fp32 masters), ``opt_state/...`` (the
optimizer's state; a moment buffer laid over the flat masters is written
leaf by leaf under the parameters' paths; under a trainable mask the
frozen leaves are among ``params/...`` in their storage type and the
moments cover the trainable ones alone), ``loss_scale/{scale,
good_steps, hysteresis}``, and ``rng``, the state of the engine's
``torch.Generator`` (JAX derives its step key from the step; the port's
generator advances, so it is saved to resume the same stream).

Crash safety, stage for stage as JAX:

1. the tag is written as ``<tag>.tmp``: the shards, then ``meta.json``
   carrying a sha256 per file, every file fsynced;
2. one atomic rename publishes it (then the directory is fsynced); a
   re-save of a tag renames the old one aside first;
3. ``latest`` is rewritten through its own tmp and rename only after the
   rename is durable.  For an async save the whole publish runs in the
   engine's commit callback, after the background write.

The ``checkpoint_crash`` fault point (``inference/faults.py``) fires at
``after_shards``, ``before_rename`` and ``before_latest``.  ``load_checkpoint``
verifies the tag (meta present, checksums match); when ``latest`` names a
torn or corrupt save it falls back to the newest tag that verifies.  An
explicit tag is never substituted.

ZeRO-Offload (JAX :179-216, :370-398): under the CPU tier the masters and
moments are read from and loaded into pinned host memory (their
write-backs settled first; after a load the compute copy is recast from
the masters), with the plain engine's leaf names.  Under the NVMe tier the
state's ``params`` are the compute copy, as in JAX, and the swap files
(masters and moments) are copied to ``<tag>/nvme_state/`` beside it and
restored from there.  ``export_fp32_state_dict`` reads the masters from
the swap files or from host memory, never from the compute copy.

Across the ranks of a process grid every rank calls save and load.  The
state is the logical one at any stage: a ZeRO engine, or one with a
``model`` axis, gathers its masters and moments from the slices and the
tensor-parallel shards (``engine.master_tree`` / ``logical_opt_state``,
collectives over ``fsdp`` and ``model``), rank 0 alone writes the tag, and
every rank waits for it before it returns.  A load reads the logical
tensors on every rank, which then takes its own slices
(``engine.load_logical_state``), so a save at one world size or
``model`` size (or on one device) loads at another, and the fp32 export
gathers the shards.

With curriculum learning on, ``meta.json`` carries the scheduler's state
under ``curriculum`` and a load restores it, as JAX does (its
``saving.py:245-246``, ``:387-388``), so either package resumes the other's
schedule.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..runtime.dataloader import unwrap_loader_chain
from ..utils.logging import log_dist
from .engine import AsyncCheckpointEngine, get_checkpoint_engine

LATEST_FILE = "latest"
TMP_SUFFIX = ".tmp"


def _ckpt_fault(stage: str) -> None:
    """Crash injection between write stages (a no-op unless a fault scope
    is installed)."""
    from ..inference import faults

    faults.check("checkpoint_crash", stage=stage)


def _fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    except OSError:
        pass  # a filesystem without fsync
    finally:
        os.close(fd)


def _fsync_dir(path: str) -> None:
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


def _file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 22), b""):
            h.update(chunk)
    return h.hexdigest()


def _tree_checksums(root: str, fsync: bool = False) -> Dict[str, str]:
    """sha256 of every file under ``root`` by relative path (``meta.json``
    excluded: it carries the map); with ``fsync`` each file is synced too,
    so the walk is also the durability barrier.  Files hash in parallel
    (hashlib releases the GIL on large buffers)."""
    paths = []
    for dirpath, _, files in os.walk(root):
        for name in sorted(files):
            p = os.path.join(dirpath, name)
            rel = os.path.relpath(p, root)
            if rel != "meta.json":
                paths.append((rel, p))

    def one(item):
        rel, p = item
        digest = _file_sha256(p)
        if fsync:
            _fsync_file(p)
        return rel, digest

    with ThreadPoolExecutor(max_workers=min(8, max(1, len(paths)))) as pool:
        return dict(pool.map(one, paths))


def verify_tag(load_dir: str, tag: str) -> Optional[str]:
    """None when the tag verifies, else the reason.  A checkpoint without
    ``shard_checksums`` verifies on structure only."""
    path = os.path.join(load_dir, tag)
    if not os.path.isdir(path):
        return f"tag directory missing: {path}"
    meta_p = os.path.join(path, "meta.json")
    if not os.path.exists(meta_p):
        return "meta.json missing (torn save: shards without commit record)"
    try:
        with open(meta_p) as fh:
            meta = json.load(fh)
    except (OSError, ValueError) as e:
        return f"meta.json unreadable: {e}"
    if not os.path.isdir(os.path.join(path, "state")):
        return "state/ missing"
    sums = meta.get("shard_checksums")
    if sums is None:
        return None
    for rel in sums:
        if not os.path.exists(os.path.join(path, rel)):
            return f"shard missing: {rel}"
    have = _tree_checksums(path)
    for rel, want in sums.items():
        if have.get(rel) != want:
            return f"shard checksum mismatch: {rel}"
    return None


def _candidate_tags(load_dir: str, exclude: Tuple[str, ...] = ()) -> List[str]:
    """Fallback candidates, newest first: published tag directories (never
    ``.tmp`` leftovers) by meta ``global_steps``, then mtime."""
    out = []
    try:
        names = os.listdir(load_dir)
    except OSError:
        return []
    for name in names:
        p = os.path.join(load_dir, name)
        if name in exclude or name.endswith(TMP_SUFFIX) or not os.path.isdir(p):
            continue
        meta_p = os.path.join(p, "meta.json")
        if os.path.exists(meta_p):
            try:
                with open(meta_p) as fh:
                    steps = int(json.load(fh).get("global_steps", -1))
            except (OSError, ValueError):
                continue
            out.append((steps, os.path.getmtime(p), name))
    out.sort(reverse=True)
    return [name for _, _, name in out]


def _tag(engine, tag: Optional[str]) -> str:
    return tag if tag is not None else f"global_step{engine.global_steps}"


def _feeds_loader(prefetch_src, loader) -> bool:
    """Whether what ``train_on_loader`` iterates draws from ``loader``
    (through ``.loader`` wrappers such as ``RepeatingLoader``): then the
    prefetcher's drained position is the loader's checkpoint state."""
    return any(link is loader for link in unwrap_loader_chain(prefetch_src))


def _nvme_dir(path: str) -> str:
    return os.path.join(path, "nvme_state")


def _settle_offload(engine) -> None:
    """An offloaded engine's host-side state complete before the host reads
    or writes it (``DeepSpeedTorchEngine._before_state_io``)."""
    settle = getattr(engine, "_before_state_io", None)
    if callable(settle):
        settle()


def _settle_deferred_metrics(engine) -> None:
    """The deferred step metrics (``runtime/prefetch.py`` ``MetricsBuffer``)
    land before a snapshot of ``skipped_steps``; here, so that direct callers
    of this module get it too."""
    flush = getattr(engine, "_flush_step_metrics", None)
    if callable(flush):
        flush()


# ---------------------------------------------------------------------------
# the training state as named leaves
# ---------------------------------------------------------------------------
def _flatten(tree, prefix: str, out: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            _flatten(v, name, out)
        else:
            out[name] = v
    return out


def _param_paths(engine) -> List[str]:
    """The paths of the leaves the optimizer holds: every parameter, or
    under a trainable mask (LoRA) the trainable ones alone; the frozen
    leaves ride ``params/...`` in their storage type."""
    paths = getattr(engine, "_trainable_paths", None)
    if paths is not None:
        return list(paths)
    return list(_flatten(engine.params, "", {}))


def _state_buffers(bufs, engine) -> Dict[str, torch.Tensor]:
    """A list of optimizer-state tensors as named leaves: under the
    parameters' paths when they lay out like the masters (one flat buffer
    over all of them, or one tensor a leaf), else by index."""
    params = engine._params_list
    names = _param_paths(engine)
    total = sum(p.numel() for p in params)
    if len(bufs) == 1 and bufs[0].dim() == 1 and bufs[0].numel() == total and len(params) > 1:
        views = bufs[0].split([p.numel() for p in params])
        return {n: v.view(p.shape) for n, v, p in zip(names, views, params)}
    if len(bufs) == len(params) and all(b.shape == p.shape for b, p in zip(bufs, params)):
        return dict(zip(names, bufs))
    return {str(i): b for i, b in enumerate(bufs)}


def _opt_leaves(node, engine) -> Any:
    if torch.is_tensor(node):
        return node
    if isinstance(node, dict):
        return {k: _opt_leaves(v, engine) for k, v in node.items()}
    return _state_buffers(list(node), engine)


def _state_tree(engine) -> Dict[str, Any]:
    """The training state as a tree; a ZeRO engine's masters and moments
    gathered into whole leaves (a collective), the rest the engine's own
    tensors."""
    ls = engine.loss_scale_state
    sharded = getattr(engine, "holds_shards", False)
    return {
        "step": engine.device_step,
        "params": engine.master_tree() if sharded else engine.params,
        "opt_state": engine.logical_opt_state() if sharded
        else _opt_leaves(engine.opt_state, engine),
        "loss_scale": {"scale": ls.scale, "good_steps": ls.good_steps,
                       "hysteresis": ls.hysteresis},
    }


def train_state(engine, tree: Optional[Dict[str, Any]] = None) -> Dict[str, torch.Tensor]:
    """The engine's training state as ``{tree path: tensor}``; the tensors
    are the engine's own (a load copies into them), or for a ZeRO engine
    the gathered whole leaves, which a load then slices."""
    out = _flatten(tree if tree is not None else _state_tree(engine), "", {})
    out["rng"] = engine.generator.get_state()
    return out


def _grid_rank(engine) -> int:
    grid = getattr(engine, "grid", None)
    return grid.rank if grid is not None else 0


def _world_barrier(engine) -> None:
    grid = getattr(engine, "grid", None)
    if grid is not None:
        from ..comm import comm
        from ..parallel.topology import GRID_AXES

        comm.barrier(GRID_AXES, mesh=grid)


# ---------------------------------------------------------------------------
# save / load
# ---------------------------------------------------------------------------
def save_checkpoint(engine, save_dir: str, tag: Optional[str] = None, client_state=None,
                    save_latest: bool = True):
    """Write ``<save_dir>/<tag>`` (default ``global_step<N>``) and, with
    ``save_latest``, point ``latest`` at it; returns the tag's path.  With
    the async engine the files are written in the background and the tag
    and ``latest`` are published at its commit."""
    _settle_deferred_metrics(engine)
    _settle_offload(engine)
    ce = get_checkpoint_engine(engine)
    tag = _tag(engine, tag)
    save_dir = os.path.abspath(save_dir)
    path = os.path.join(save_dir, tag)
    tmp_path = path + TMP_SUFFIX
    state = train_state(engine)  # every rank: a ZeRO engine gathers its slices
    if _grid_rank(engine) != 0:  # rank 0 writes the world's tag
        _world_barrier(engine)
        return path
    ce.wait()  # a pending save commits before this one starts
    if os.path.isdir(tmp_path):
        shutil.rmtree(tmp_path)  # the leftover of a torn save
    os.makedirs(tmp_path, exist_ok=True)
    ce.create(tag)
    ce.save(state, os.path.join(tmp_path, "state"))
    nvme = getattr(engine, "_nvme_opt", None)
    if nvme is not None:
        # the NVMe tier: masters and moments live in the swap pool, not the
        # training state; they are saved beside it
        nvme.save_to(_nvme_dir(tmp_path))
    meta = {
        "global_steps": engine.global_steps,
        "skipped_steps": engine.skipped_steps,
        "lr_scheduler": engine.lr_scheduler.state_dict(),
        "client_state": client_state or {},
        "zero_stage": engine.config.zero_optimization.stage,
        "dp_world_size": engine.dp_world_size,
    }
    loader = getattr(engine, "training_dataloader", None)
    if loader is not None and hasattr(loader, "state_dict"):
        ds_state = loader.state_dict()
        pf = getattr(engine, "_active_prefetcher", None)
        if pf is not None and _feeds_loader(getattr(engine, "_prefetch_loader", None), loader):
            # mid-iteration under train_on_loader: the sampler ran ahead of
            # the batches parked in the prefetcher; record the oldest
            # unconsumed one's position so that resume replays exactly
            drained = pf.resume_state()
            if drained is not None:
                ds_state = drained
        if ds_state is not None:
            meta["data_sampler"] = ds_state
    if getattr(engine, "curriculum_scheduler", None) is not None:
        meta["curriculum"] = engine.curriculum_scheduler.get_state()

    def finalize():
        """Checksum and fsync the shards, write meta.json, rename the tmp
        directory to the tag, and only then rewrite ``latest``."""
        _ckpt_fault("after_shards")
        meta["shard_checksums"] = _tree_checksums(tmp_path, fsync=True)
        with open(os.path.join(tmp_path, "meta.json"), "w") as fh:
            json.dump(meta, fh)
            fh.flush()
            os.fsync(fh.fileno())
        _ckpt_fault("before_rename")
        if os.path.isdir(path):
            # rename-aside, not rmtree-then-rename: the unpublished window is
            # two renames wide; the aside keeps the .tmp suffix so a crash
            # leftover is never a fallback candidate
            aside = path + ".old" + TMP_SUFFIX
            shutil.rmtree(aside, ignore_errors=True)
            os.rename(path, aside)
            os.rename(tmp_path, path)
            shutil.rmtree(aside, ignore_errors=True)
        else:
            os.rename(tmp_path, path)
        _fsync_dir(save_dir)
        if not save_latest:
            return
        _ckpt_fault("before_latest")
        latest_tmp = os.path.join(save_dir, LATEST_FILE + TMP_SUFFIX)
        with open(latest_tmp, "w") as fh:
            fh.write(tag)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(latest_tmp, os.path.join(save_dir, LATEST_FILE))
        _fsync_dir(save_dir)

    if isinstance(ce, AsyncCheckpointEngine) and ce.pending:
        ce.set_commit_callback(finalize)  # 'latest' is published at commit only
    else:
        finalize()
    log_dist(f"saved checkpoint {path}")
    _world_barrier(engine)
    return path


def get_latest_tag(load_dir: str) -> Optional[str]:
    p = os.path.join(load_dir, LATEST_FILE)
    if not os.path.exists(p):
        return None
    with open(p) as fh:
        return fh.read().strip()


def load_checkpoint(engine, load_dir: str, tag: Optional[str] = None,
                    load_optimizer_states: bool = True,
                    load_lr_scheduler_states: bool = True) -> Tuple[Optional[str], Dict[str, Any]]:
    """Restore ``<load_dir>/<tag>`` (default: ``latest``, falling back to the
    newest tag that verifies) into the engine in place; returns ``(path,
    client_state)``, or ``(None, {})`` when there is nothing to load."""
    _settle_deferred_metrics(engine)  # buffered metrics are pre-restore steps
    _settle_offload(engine)
    ce = get_checkpoint_engine(engine)
    ce.wait()  # a pending async save lands before the read
    explicit = tag is not None
    tag = tag or get_latest_tag(load_dir)
    if tag is None:
        log_dist(f"no checkpoint found under {load_dir}")
        return None, {}
    err = verify_tag(load_dir, tag)
    if err is not None:
        if explicit:
            raise RuntimeError(f"checkpoint tag '{tag}' failed verification: {err}")
        log_dist(f"WARNING: latest checkpoint '{tag}' failed verification ({err}); "
                 "falling back to the previous valid tag")
        fallback = None
        for cand in _candidate_tags(load_dir, exclude=(tag,)):
            cand_err = verify_tag(load_dir, cand)
            if cand_err is None:
                fallback = cand
                break
            log_dist(f"WARNING: candidate '{cand}' also invalid: {cand_err}")
        if fallback is None:
            log_dist(f"no valid checkpoint found under {load_dir}")
            return None, {}
        tag = fallback
    path = os.path.join(os.path.abspath(load_dir), tag)
    tree = _state_tree(engine)
    targets = train_state(engine, tree)
    if not load_optimizer_states:
        targets = {k: v for k, v in targets.items() if not k.startswith("opt_state/")}
    ce.load(os.path.join(path, "state"), targets)
    if getattr(engine, "holds_shards", False):  # this rank's slices of the whole leaves
        engine.load_logical_state(tree["params"],
                                  tree["opt_state"] if load_optimizer_states else None)
    nvme = getattr(engine, "_nvme_opt", None)
    if nvme is not None and load_optimizer_states:
        nvme.restore_from(_nvme_dir(path))
    after = getattr(engine, "_after_state_load", None)
    if callable(after):
        after()
    engine.generator.set_state(targets["rng"])
    with open(os.path.join(path, "meta.json")) as fh:
        meta = json.load(fh)
    engine.global_steps = int(meta["global_steps"])
    engine.skipped_steps = int(meta.get("skipped_steps", 0))
    if load_lr_scheduler_states and "lr_scheduler" in meta:
        engine.lr_scheduler.load_state_dict(meta["lr_scheduler"])
    loader = getattr(engine, "training_dataloader", None)
    if (loader is not None and hasattr(loader, "load_state_dict")
            and meta.get("data_sampler") is not None):
        loader.load_state_dict(meta["data_sampler"])
    if getattr(engine, "curriculum_scheduler", None) is not None and "curriculum" in meta:
        engine.curriculum_scheduler.set_state(meta["curriculum"])
    log_dist(f"loaded checkpoint {path}")
    return path, meta.get("client_state", {})


def export_fp32_state_dict(engine):
    """The fp32 masters as the parameter tree of CPU tensors (the
    reference's ``zero_to_fp32``, ``utils/zero_to_fp32.py:533``): from the
    swap files under the NVMe tier (``engine.params`` is the compute copy
    there), from host memory under the CPU tier."""
    _settle_offload(engine)
    nvme = getattr(engine, "_nvme_opt", None)
    if nvme is not None:
        from ..ops.optimizers import set_path

        out: Dict[str, Any] = {}
        for path, leaf in zip(engine._nvme_paths, nvme.export_masters()):
            set_path(out, path, leaf)
        return out

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return node.detach().to("cpu", copy=True)

    if getattr(engine, "holds_shards", False):  # the shards gathered (every rank calls)
        return walk(engine.master_tree())
    return walk(engine.params)
