"""ZeRO-Offload on one card: the CPU tier and the NVMe tier — counterpart
of ``deepspeed_tpu/runtime/offload.py`` (``NVMeOptimizer``) and of the CPU
tier of ``deepspeed_tpu/runtime/engine.py`` (:266-330, :698-752).

**The CPU tier** (``HostStream``; ``offload_optimizer`` or
``offload_param`` ``"cpu"``).  The fp32 masters and every moment of the
optimizer live in pinned host memory as flat buffers laid out like the
plain engine's; the card holds the compute-type parameters
(``ComputeCopy``), the fp32 gradient buffer and two sets of staging
chunks.  Each step streams the state through the card, as XLA streams
``pinned_host`` state through HBM on the TPU: chunk i+1's masters and
moments are copied in on a copy stream while chunk i updates on the
compute stream (K8 for the Adam family, the eager rules otherwise), and
chunk i goes back out on a second copy stream after its masters are cast
into the compute copy.  An elementwise rule takes any cut of the buffers
(``CHUNK_ELEMS`` elements, a multiple of 4, so K8 keeps its 16-byte
accesses); Lamb and Muon take whole leaves, a chunk at least as large as
the largest leaf.  Each chunk's update is the plain update's on those
elements, so the tier changes no number.  Host memory is pinned by
``cudaHostRegister`` on a plain allocation (``PinnedPool``): PyTorch's
caching host allocator rounds a request up to a power of two.

**The gradients.**  With the masters off the card the compute copy holds
the autograd leaves: one a layer of each stacked ``[L, ...]`` weight
(``models.transformer._unstack`` takes the sequence), one each for the
rest.  Each leaf's gradient is folded into the fp32 gradient buffer as it
lands (``register_post_accumulate_grad_hook``) and freed, so a layer's
gradient in the compute type lives only until its backward ends (the
plain engine's stacked weights hold every layer's until the first layer's
backward), and the buffer sums micro-batches in fp32 as the plain
engine's does.

**The NVMe tier** (``NVMeOptimizer``; ``offload_optimizer: "nvme"``).
The masters and Adam moments are swap files, one per leaf and part
(``<leaf path, "/" as "__">.{master,m,v}.swp``, raw fp32 bytes: the JAX
package's names and bytes, so a swap directory reads back in either
package), managed by ``nvme.TensorSwapper`` over the async I/O engine and
updated in place by ``ops.host_adam.HostAdamW``.  The walk over the
leaves keeps ``prefetch_depth`` leaves' reads in flight ahead of the
update, and ``on_leaf(i, master)`` lets the engine start each leaf's
upload as soon as it is updated.
"""
from __future__ import annotations

import contextlib
import math
import os
import shutil
import weakref
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..nvme.swap import TensorSwapper
from ..ops.host_adam import HostAdamW
from ..ops.optimizers import _leaf_views, set_path
from ..utils.logging import log_dist

# elements of one staging chunk of the CPU tier (a multiple of 4): 256 MB
# per fp32 buffer, 1.5 GB of staging for AdamW's two sets of three buffers
CHUNK_ELEMS = 1 << 26


# ---------------------------------------------------------------------------
# pinned host memory
# ---------------------------------------------------------------------------
def _unregister(ptrs: List[int]) -> None:
    if not ptrs:
        return
    cudart = torch.cuda.cudart()
    while ptrs:
        cudart.cudaHostUnregister(ptrs.pop())


class PinnedPool:
    """Host buffers for a card: plain allocations page-locked with
    ``cudaHostRegister`` (exactly the bytes asked for), unregistered when
    the pool closes or is collected.  For a CPU device they are plain
    tensors (there is nothing to pin for).  A failed registration raises:
    no pageable buffer stands in."""

    def __init__(self, device: torch.device):
        self.device = device
        self.registered_bytes = 0
        self._ptrs: List[int] = []
        self._keep: List[torch.Tensor] = []
        self._finalizer = weakref.finalize(self, _unregister, self._ptrs)

    def full(self, n: int, fill: float, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """``n`` elements set to ``fill``.  The fill runs on every core
        before the registration, so the pages are faulted in in parallel
        and the registration only locks them."""
        t = torch.full((n,), fill, dtype=dtype)
        if self.device.type != "cuda":
            return t
        nbytes = n * t.element_size()
        if nbytes:
            err = torch.cuda.cudart().cudaHostRegister(t.data_ptr(), nbytes, 0)
            if int(err) != 0:
                raise RuntimeError(f"cudaHostRegister of {nbytes} bytes failed "
                                   f"(cudaError {int(err)}): the offload state needs "
                                   "pinned host memory")
            self._ptrs.append(t.data_ptr())
            self._keep.append(t)  # the memory outlives its registration
            self.registered_bytes += nbytes
        return t

    def close(self) -> None:
        self._finalizer()


# ---------------------------------------------------------------------------
# the compute copy: the autograd leaves of an offloaded engine
# ---------------------------------------------------------------------------
class ComputeCopy:
    """The compute-type parameters on the card as one flat buffer: ``tree``
    / ``leaves`` are its views shaped as the parameters, and ``loss_tree``
    the autograd leaves the loss runs on, views of the same memory (a tuple
    of per-layer leaves for each weight under ``layers``).  Each autograd
    leaf's gradient is added to its view of ``grads`` (fp32) the moment
    autograd has accumulated it, and then freed."""

    def __init__(self, shapes: Sequence[Tuple[Tuple[str, ...], torch.Size]],
                 dtype: torch.dtype, device: torch.device, grads: List[torch.Tensor]):
        total = sum(s.numel() for _, s in shapes)
        self.flat = torch.empty(total, dtype=dtype, device=device)
        self.tree: Dict[str, Any] = {}
        self.loss_tree: Dict[str, Any] = {}
        self.leaves: List[torch.Tensor] = []
        off = 0
        for (path, shape), g in zip(shapes, grads):
            n = shape.numel()
            view = self.flat[off:off + n].view(shape)
            set_path(self.tree, path, view)
            self.leaves.append(view)
            if path[0] == "layers" and len(shape) > 0:  # stacked [L, ...]
                set_path(self.loss_tree, path, tuple(self._leaf(view[l], g[l])
                                                     for l in range(shape[0])))
            else:
                set_path(self.loss_tree, path, self._leaf(self.flat[off:off + n].view(shape), g))
            off += n

    @classmethod
    def _leaf(cls, t: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        t.requires_grad_(True)
        t.register_post_accumulate_grad_hook(cls._folder(g))
        return t

    @staticmethod
    def _folder(g: torch.Tensor) -> Callable:
        def fold(p: torch.Tensor) -> None:
            g.add_(p.grad)
            p.grad = None

        return fold

    @torch.no_grad()
    def load(self, leaves: Sequence[torch.Tensor]) -> None:
        """Set each leaf from a tensor of its shape (cast on the card)."""
        for dst, src in zip(self.leaves, leaves):
            dst.copy_(src)


def leaf_paths(tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[Tuple[str, ...], Any]]:
    """``[(path, leaf)]`` in the tree's order."""
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out.extend(leaf_paths(v, prefix + (k,)))
        else:
            out.append((prefix + (k,), v))
    return out


# ---------------------------------------------------------------------------
# the CPU tier
# ---------------------------------------------------------------------------
class _Chunk(NamedTuple):
    start: int  # element range of the masters
    stop: int
    leaves: Optional[Tuple[int, int]]  # leaf range for a leafwise rule, else None
    slots: List[Tuple[int, int]]  # each slot's element range


class HostStream:
    """The CPU tier's state and its streamed update.

    ``masters`` is the flat fp32 master buffer and ``state`` the
    optimizer's state, both in pinned host memory and laid out as the plain
    engine lays them (``state["count"]`` stays on the card);
    ``update(...)`` applies one optimizer step chunk by chunk and casts the
    new masters into ``compute``."""

    def __init__(self, optimizer, shapes: Sequence[torch.Size], device: torch.device):
        self.optimizer = optimizer
        self.device = device
        self.pool = PinnedPool(device)
        self.sizes = [s.numel() for s in shapes]
        self.offsets = [0]
        for n in self.sizes:
            self.offsets.append(self.offsets[-1] + n)
        total = self.offsets[-1]
        self.masters = self.pool.full(total, 0.0)
        self.leaves = [self.masters[a:a + n].view(s)
                       for a, n, s in zip(self.offsets, self.sizes, shapes)]
        # the optimizer's slots over the host leaves, as init() lays them
        self.slots = optimizer.slots(self.leaves)
        self.state: Dict[str, Any] = {
            "count": torch.zeros((), dtype=torch.int32, device=device)}
        self.slot_flat: List[torch.Tensor] = []
        self.slot_offsets: List[List[int]] = []  # per slot: offset of each covered leaf
        for path, fill, idx in self.slots:
            covered = range(len(self.leaves)) if idx is None else idx
            offs = {}
            n = 0
            for i in covered:
                offs[i] = n
                n += self.sizes[i]
            flat = self.pool.full(n, fill)
            self.slot_flat.append(flat)
            self.slot_offsets.append(offs)
            sub = [self.leaves[i] for i in covered]
            set_path(self.state, path,
                     [flat] if idx is None else (_leaf_views([flat], sub) if sub else []))
        self.chunks = self._plan(CHUNK_ELEMS)
        width = max(c.stop - c.start for c in self.chunks) if self.chunks else 0
        slot_width = [max((b - a for a, b in (c.slots[k] for c in self.chunks)), default=0)
                      for k in range(len(self.slots))]
        # two staging sets: one chunk updates while the next comes in
        self.staging = [
            (torch.empty(width, dtype=torch.float32, device=device),
             [torch.empty(w, dtype=torch.float32, device=device) for w in slot_width])
            for _ in range(2)]
        self._count = torch.zeros((), dtype=torch.int32, device=device)
        cuda = device.type == "cuda"
        self.h2d = torch.cuda.Stream(device=device) if cuda else None
        self.d2h = torch.cuda.Stream(device=device) if cuda else None
        self._in = [torch.cuda.Event() for _ in range(2)] if cuda else None
        self._up = [torch.cuda.Event() for _ in range(2)] if cuda else None
        self._out = [torch.cuda.Event() for _ in range(2)] if cuda else None
        self.chunk_launches = 0  # optimizer updates run (one per chunk per step)

    # -- layout ----------------------------------------------------------
    def _slot_range(self, k: int, first: int, last: int) -> Tuple[int, int]:
        """Slot k's element range over leaves [first, last)."""
        offs = self.slot_offsets[k]
        covered = [i for i in range(first, last) if i in offs]
        if not covered:
            return (0, 0)
        return offs[covered[0]], offs[covered[-1]] + self.sizes[covered[-1]]

    def _plan(self, chunk_elems: int) -> List[_Chunk]:
        total = self.offsets[-1]
        if self.optimizer.ELEMENTWISE and all(idx is None for _, _, idx in self.slots):
            step = max(4, chunk_elems - chunk_elems % 4)
            return [_Chunk(a, min(a + step, total), None,
                           [(a, min(a + step, total))] * len(self.slots))
                    for a in range(0, total, step)]
        chunks, first = [], 0
        while first < len(self.sizes):
            last = first + 1
            while (last < len(self.sizes)
                   and self.offsets[last + 1] - self.offsets[first] <= chunk_elems):
                last += 1
            chunks.append(_Chunk(self.offsets[first], self.offsets[last], (first, last),
                                 [self._slot_range(k, first, last)
                                  for k in range(len(self.slots))]))
            first = last
        return chunks

    @property
    def staging_bytes(self) -> int:
        return sum(t.numel() * 4 for m, slots in self.staging for t in (m, *slots))

    @property
    def host_bytes(self) -> int:
        return self.masters.numel() * 4 + sum(f.numel() * 4 for f in self.slot_flat)

    # -- the streamed update --------------------------------------------
    def _stream(self, s):
        return torch.cuda.stream(s) if s is not None else contextlib.nullcontext()

    def _copy_in(self, c: int) -> None:
        ch = self.chunks[c]
        m, slots = self.staging[c % 2]
        with self._stream(self.h2d):
            if self.h2d is not None:
                self.h2d.wait_event(self._out[c % 2])  # this set's last write-back is out
            m[:ch.stop - ch.start].copy_(self.masters[ch.start:ch.stop], non_blocking=True)
            for buf, flat, (a, b) in zip(slots, self.slot_flat, ch.slots):
                buf[:b - a].copy_(flat[a:b], non_blocking=True)
            if self.h2d is not None:
                self._in[c % 2].record(self.h2d)

    def _copy_out(self, c: int) -> None:
        ch = self.chunks[c]
        m, slots = self.staging[c % 2]
        with self._stream(self.d2h):
            if self.d2h is not None:
                self.d2h.wait_event(self._up[c % 2])
            self.masters[ch.start:ch.stop].copy_(m[:ch.stop - ch.start], non_blocking=True)
            for buf, flat, (a, b) in zip(slots, self.slot_flat, ch.slots):
                flat[a:b].copy_(buf[:b - a], non_blocking=True)
            if self.d2h is not None:
                self._out[c % 2].record(self.d2h)

    def _chunk_args(self, c: int, grads: torch.Tensor, grad_leaves: List[torch.Tensor]):
        """(params, grads, state) of chunk c, over the staging set it uses."""
        ch = self.chunks[c]
        m, slots = self.staging[c % 2]
        m = m[:ch.stop - ch.start]
        state: Dict[str, Any] = {"count": self._count}
        if ch.leaves is None:
            for (path, _, _), buf, (a, b) in zip(self.slots, slots, ch.slots):
                set_path(state, path, [buf[:b - a]])
            return [m], [grads[ch.start:ch.stop]], state
        first, last = ch.leaves
        params = _leaf_views([m], self.leaves[first:last])
        for k, ((path, _, idx), buf, (a, b)) in enumerate(zip(self.slots, slots, ch.slots)):
            if idx is None:
                set_path(state, path, [buf[:b - a]])
            else:
                sub = [self.leaves[i] for i in range(first, last) if i in self.slot_offsets[k]]
                set_path(state, path, _leaf_views([buf[:b - a]], sub) if sub else [])
        return params, grad_leaves[first:last], state

    @torch.no_grad()
    def update(self, grads: torch.Tensor, grad_leaves: List[torch.Tensor],
               compute_flat: torch.Tensor, lr, finite=None) -> None:
        """One optimizer step over the streamed state: ``grads`` is the flat
        fp32 gradient buffer on the card (``grad_leaves`` its leaf views),
        ``compute_flat`` the compute copy, set from the new masters."""
        if not self.chunks:
            return
        comp = torch.cuda.current_stream(self.device) if self.h2d is not None else None
        if comp is not None:
            # the last step's write-backs land before this step reads the host
            self.h2d.wait_stream(self.d2h)
        count = self.state["count"]
        self._copy_in(0)
        for c, ch in enumerate(self.chunks):
            if c + 1 < len(self.chunks):
                self._copy_in(c + 1)
            if comp is not None:
                comp.wait_event(self._in[c % 2])
            self._count.copy_(count)  # every chunk counts the same update
            params, g, state = self._chunk_args(c, grads, grad_leaves)
            self.optimizer.step(params, g, state, lr, finite)
            self.chunk_launches += 1
            compute_flat[ch.start:ch.stop].copy_(self.staging[c % 2][0][:ch.stop - ch.start])
            if comp is not None:
                self._up[c % 2].record(comp)
            self._copy_out(c)
        count.copy_(self._count)

    @torch.no_grad()
    def refresh(self, compute_flat: torch.Tensor) -> None:
        """Set the compute copy from the host masters, chunk by chunk
        through the staging buffer (after a checkpoint load)."""
        self.settle()
        m = self.staging[0][0]
        for ch in self.chunks:
            n = ch.stop - ch.start
            m[:n].copy_(self.masters[ch.start:ch.stop])
            compute_flat[ch.start:ch.stop].copy_(m[:n])

    def settle(self) -> None:
        """Block until every write-back of the host state has landed (before
        the host reads or writes it: checkpoints, exports)."""
        if self.d2h is not None:
            self.d2h.synchronize()

    def close(self) -> None:
        self.settle()
        self.pool.close()


# ---------------------------------------------------------------------------
# the NVMe tier
# ---------------------------------------------------------------------------
def swap_names(paths: Sequence[Tuple[str, ...]]) -> List[str]:
    """The swap files' stems: each leaf's tree path joined by ``__`` (JAX
    ``_leaf_names``)."""
    return ["__".join(p) for p in paths]


class NVMeOptimizer:
    """An optimizer whose whole state lives on local SSD.

    ``init(leaves)`` writes fp32 masters and zeroed Adam moments for every
    leaf; ``step(grads, lr, step_num, clip_coef)`` streams each leaf's
    (master, m, v) in, applies the host AdamW, streams the state back out,
    and returns the updated masters (or hands each to ``on_leaf``)."""

    def __init__(self, swap_dir: str, lr: float = 1e-3,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, num_threads: int = 8, queue_depth: int = 32):
        os.makedirs(swap_dir, exist_ok=True)
        self.swapper = TensorSwapper(swap_dir, num_threads=num_threads,
                                     queue_depth=queue_depth)
        self.opt = HostAdamW(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay)
        self._names: List[str] = []
        self._shapes: List[Tuple[int, ...]] = []
        self.bytes_read = 0  # of swap files, since construction
        self.bytes_written = 0

    def init(self, names: Sequence[str], leaves: Sequence[torch.Tensor]) -> None:
        """Write fp32 masters (``leaves``, any device and type) and zeroed
        moments for each name."""
        self._names = list(names)
        self._shapes = [tuple(t.shape) for t in leaves]
        total = 0
        for name, leaf in zip(self._names, leaves):
            host = leaf.detach().to("cpu", torch.float32).contiguous()
            self._swap_out(f"{name}.master", host)
            zeros = torch.zeros_like(host)
            self._swap_out(f"{name}.m", zeros)
            self._swap_out(f"{name}.v", zeros)
            total += host.numel()
        self.swapper.flush()
        log_dist(f"nvme offload: {len(self._names)} tensors, {total * 12 / 1e6:.1f} MB "
                 f"optimizer state on {self.swapper.dir}")

    def _swap_out(self, name: str, t: torch.Tensor) -> None:
        self.swapper.swap_out(name, t)
        self.bytes_written += t.numel() * t.element_size()

    def _swap_in(self, name: str) -> torch.Tensor:
        t = self.swapper.swap_in(name)
        self.bytes_read += t.numel() * t.element_size()
        return t

    def _prefetch(self, name: str) -> None:
        for part in ("master", "m", "v"):
            self.swapper.prefetch(f"{name}.{part}")

    def step(self, grads, lr: float, step_num: int, clip_coef: float = 1.0,
             on_leaf: Optional[Callable[[int, torch.Tensor], None]] = None,
             prefetch_depth: int = 2):
        """One AdamW step; returns the updated fp32 masters, or None when
        ``on_leaf(i, master)`` takes each as it is done.

        ``grads`` yields one CPU tensor a leaf (fp32, or bf16 whose bits go
        to the host kernel as they are), in order; ``clip_coef`` (global-norm
        clipping, computed on the card) scales them in fp32 first, as JAX
        does.  ``step_num`` is the 1-based step of the bias correction.
        ``prefetch_depth`` leaves' reads stream in ahead of the walk and the
        write-backs are asynchronous."""
        if len(grads) != len(self._names):
            raise ValueError(f"grad leaves {len(grads)} != swapped leaves {len(self._names)}")
        for j in range(min(prefetch_depth, len(self._names))):
            self._prefetch(self._names[j])
        out: List[torch.Tensor] = []
        for i, (name, g) in enumerate(zip(self._names, grads)):
            if i + prefetch_depth < len(self._names):
                self._prefetch(self._names[i + prefetch_depth])
            master = self._swap_in(f"{name}.master")
            m = self._swap_in(f"{name}.m")
            v = self._swap_in(f"{name}.v")
            g = g.reshape(-1)
            if clip_coef != 1.0:
                g = g.float() * clip_coef  # JAX: np.asarray(g, float32) * clip_coef
            self.opt.step_count = step_num - 1  # HostAdamW counts each call
            self.opt.step(master.view(-1), g, m.view(-1), v.view(-1), lr=lr)
            self._swap_out(f"{name}.master", master)
            self._swap_out(f"{name}.m", m)
            self._swap_out(f"{name}.v", v)
            if on_leaf is not None:
                on_leaf(i, master)
            else:
                out.append(master)
        return None if on_leaf is not None else out

    def export_masters(self) -> List[torch.Tensor]:
        """A blocking read of every fp32 master (checkpoint export)."""
        leaves = [self._swap_in(f"{n}.master") for n in self._names]
        for n, t in zip(self._names, leaves):  # swap_in consumed the landing buffer
            self._swap_out(f"{n}.master", t)
        self.swapper.flush()
        return leaves

    def load_masters(self, leaves: Sequence[torch.Tensor]) -> None:
        """Overwrite the masters (moments reset)."""
        self.init(self._names, leaves)

    def save_to(self, out_dir: str) -> None:
        """Copy the whole swap state (masters and moments) into a
        checkpoint directory."""
        self.swapper.flush()
        os.makedirs(out_dir, exist_ok=True)
        for name in self._names:
            for part in ("master", "m", "v"):
                shutil.copy2(os.path.join(self.swapper.dir, f"{name}.{part}.swp"), out_dir)

    def restore_from(self, in_dir: str) -> None:
        """Load masters and moments from a checkpoint directory into the
        swap pool (the shapes are the live ones, from ``init``)."""
        for name, shape in zip(self._names, self._shapes):
            for part in ("master", "m", "v"):
                path = os.path.join(in_dir, f"{name}.{part}.swp")
                want = 4 * math.prod(shape)
                if os.path.getsize(path) != want:
                    raise ValueError(f"{path}: {os.path.getsize(path)} bytes, the live "
                                     f"leaf {shape} needs {want}")
                t = self.swapper.engine.read(path, torch.float32, shape)
                self._swap_out(f"{name}.{part}", t)
        self.swapper.flush()

    def close(self) -> None:
        self.swapper.close()
