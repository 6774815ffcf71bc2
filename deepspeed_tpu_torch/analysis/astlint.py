"""Source-level lint: AST passes over ``deepspeed_tpu_torch`` — counterpart
of ``deepspeed_tpu/analysis/astlint.py``, re-scoped over the port.

Five rules, each guarding an invariant the runtime cannot check for
itself:

- **host-sync** — torch's device round trips (``.item()``, ``.tolist()``,
  ``.cpu()``, ``.numpy()``, ``torch.cuda.synchronize`` and an
  ``Event`` / ``Stream``'s ``.synchronize()``; JAX's ``block_until_ready``
  / ``device_get`` too) or ``float(<expr>)`` inside the serving tick / step
  hot paths.  Scoped to the functions in :data:`HOT_PATHS` (``"*"`` = every
  function in the file).  The designed syncs are listed in
  :data:`HOST_SYNC_ALLOWED`, each with its reason.
- **global-state** — a ``global`` rebind is how one engine's flip silently
  reconfigures every later engine in the process; the port's only one is
  grandfathered in :data:`GLOBAL_BASELINE`, and the set may only shrink.
- **raw-dist-collective** — a ``torch.distributed`` collective (or its
  import by name) outside ``comm/`` bypasses the quantized transport
  layer (``comm.qcomm``), so the ``fmt='none'`` A/B lever stops being
  universal.
- **controller-import** / **fleet-import** — the online controller
  (``autotuning/controller.py``) and the fleet plane (``telemetry/fleet.py``)
  run on their own threads and may host-sync or do socket I/O; a tick-path
  module (any file in :data:`HOT_PATHS`) importing them inverts that
  layering.

A trailing ``# lint: allow(<rule>)`` comment on the offending line
suppresses that line.  The tier-1 gate (``tests/test_torch_analysis.py``)
runs :func:`lint_package` over the port and fails on any violation.
"""
from __future__ import annotations

import ast
import fnmatch
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# functions whose bodies may never host-sync (file -> names, "*" = all);
# keys are paths under deepspeed_tpu_torch/
HOT_PATHS: Dict[str, Set[str]] = {
    # the engine's tick / step loop and the KV-handoff seam
    "inference/engine_v2.py": {
        "_run_packed_prefill", "prefill_entries", "_decode_tick", "_spec_tick", "step",
        "step_n", "_decode_burst", "_burst_tick", "extract_kv_blocks", "inject_kv_blocks",
    },
    # the serve loop's per-tick driver and its intake surface, which runs
    # under the scheduler's intake lock: a sync there stalls every submitter
    "inference/scheduler.py": {
        "tick", "try_submit", "_try_submit_locked", "adopt_prefilled",
        "_adopt_prefilled_locked", "cancel", "detach", "_release", "_release_locked",
        "_admit_phase", "_try_admit_locked", "_expire_phase", "_preempt", "retry_after_ms",
        "pop_result", "_plan_megastep", "_remaining_emit", "_decode_phase",
        "_dispatch_decode",
    },
    # the router's control loop and its load reads; the handoff codec is
    # host work by design
    "serving/router.py": {"tick", "try_submit", "_route", "_route_to_worker", "_candidates",
                          "_maybe_migrate", "_kill_worker", "_finish"},
    "serving/handoff.py": {"extract_request", "inject_request"},
    "serving/pool.py": {"load", "queue_depth", "running", "headroom_blocks", "shedding"},
    # the socket wire: frame packing and the codec ride every message
    "serving/transport.py": {"pack_frame", "encode_handoff", "decode_handoff", "send_frame",
                             "recv_frame", "_op_step_burst", "_request_views"},
    "serving/remote.py": {"begin_tick", "finish_tick", "request_view"},
    # model code the ticks run (a CUDA graph holds the burst's)
    "inference/model_runner.py": {"*"},
    "inference/sampling.py": {"*"},
    "inference/paged.py": {"*"},
    # the packed-ctx kernel's dispatch and wrapper: every chunked prefill,
    # prefix hit and verify pass
    "ops/kernels/ctx_attention.py": {"*"},
    # allocation bookkeeping under the scheduler's intake lock
    "inference/ragged.py": {"allocate", "can_allocate", "_evict_one", "_push_free",
                            "stripe_of", "free", "invalidate", "ensure_capacity",
                            "ensure_writable"},
    # the fleet collector's pull loop: host bookkeeping beside the router
    "telemetry/fleet.py": {"pull_once", "_run", "ingest"},
}

# the designed syncs of the hot paths: (file, function) -> the sync calls
# allowed there, for JAX's reasons (its astlint.py:47-60)
HOST_SYNC_ALLOWED: Dict[Tuple[str, str], Set[str]] = {
    # a burst's ONE fetch of its emitted rows: the whole design of the
    # megastep is that n ticks pay one host round trip (JAX np.asarray)
    ("inference/engine_v2.py", "_decode_burst"): {"cpu", "numpy"},
    # the KV handoff's designed host copy of the pages it ships
    ("inference/engine_v2.py", "extract_kv_blocks"): {"cpu"},
}

# grandfathered `global` rebinds: (file, name).  Shrink-only.
GLOBAL_BASELINE: Set[Tuple[str, str]] = {
    ("inference/faults.py", "_GLOBAL"),
}

# files allowed to call torch.distributed collectives: the comm layer
DIST_COLLECTIVE_ALLOWED = ("comm/*",)

_DIST_COLLECTIVES = {
    "all_reduce", "all_gather", "all_gather_into_tensor", "all_gather_object",
    "reduce_scatter", "reduce_scatter_tensor", "all_to_all", "all_to_all_single",
    "broadcast", "broadcast_object_list", "reduce", "scatter", "gather", "send", "recv",
    "isend", "irecv", "batch_isend_irecv", "barrier",
}
_HOST_SYNC_ATTRS = {"item", "tolist", "cpu", "numpy", "synchronize", "block_until_ready"}
_HOST_SYNC_FUNCS = {"device_get"}

# the adaptation controller's module and entry points
_CONTROLLER_MODULE = "autotuning.controller"
_CONTROLLER_NAMES = {"OnlineController", "attach_controller"}
# the fleet plane observes the data plane: no tick-path module imports it
_FLEET_MODULE = "telemetry.fleet"
_FLEET_NAMES = {"FleetRegistry", "FleetCollector", "SloMonitor",
                "attach_fleet_collector", "fleet_chrome_trace"}


@dataclass(frozen=True)
class LintViolation:
    rule: str  # host-sync | global-state | raw-dist-collective | *-import
    path: str  # repo-relative file
    line: int
    message: str

    def __str__(self) -> str:  # pytest-friendly
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


def _allowed(source_lines: Sequence[str], lineno: int, rule: str) -> bool:
    if 0 < lineno <= len(source_lines):
        return f"lint: allow({rule})" in source_lines[lineno - 1]
    return False


class _Visitor(ast.NodeVisitor):
    def __init__(self, relpath: str, source_lines: Sequence[str]):
        self.relpath = relpath
        self.lines = source_lines
        self.hot_names = HOT_PATHS.get(relpath)
        self.func_stack: List[str] = []
        self.out: List[LintViolation] = []
        self.allowed_hits: Set[Tuple[str, str, str]] = set()

    # -- helpers ----------------------------------------------------------
    def _emit(self, rule: str, node: ast.AST, msg: str) -> None:
        if not _allowed(self.lines, node.lineno, rule):
            self.out.append(LintViolation(rule, self.relpath, node.lineno, msg))

    def _in_hot_path(self) -> bool:
        if self.hot_names is None or not self.func_stack:
            return False
        return "*" in self.hot_names or bool(
            set(self.func_stack) & self.hot_names
        )

    # -- rule: global mutable state ---------------------------------------
    def visit_Global(self, node: ast.Global) -> None:
        for name in node.names:
            if (self.relpath, name) not in GLOBAL_BASELINE:
                self._emit(
                    "global-state", node,
                    f"new process-global mutable state 'global {name}' — "
                    "one call site reconfigures every engine in the process "
                    "(the set_fused_serving bug class); carry the state on "
                    "the engine/context object instead",
                )
        self.generic_visit(node)

    # -- rule: raw torch.distributed collectives --------------------------
    def _dist_allowed(self) -> bool:
        return any(fnmatch.fnmatch(self.relpath, pat) for pat in DIST_COLLECTIVE_ALLOWED)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        base = node.value
        is_dist = ((isinstance(base, ast.Name) and base.id == "dist")
                   or (isinstance(base, ast.Attribute) and base.attr == "distributed"))
        if node.attr in _DIST_COLLECTIVES and is_dist and not self._dist_allowed():
            self._emit("raw-dist-collective", node,
                       f"raw torch.distributed.{node.attr} outside comm/ — route through "
                       "comm.qcomm so the fmt='none' A/B lever stays universal")
        self.generic_visit(node)

    # -- rule: controller import from a tick path ---------------------------
    def _controller_import(self, node: ast.AST, what: str) -> None:
        self._emit(
            "controller-import", node,
            f"tick-path module imports the adaptation controller ({what}) "
            "— the controller thread may host-sync and is excluded from "
            "HOT_PATHS precisely because nothing on the tick path may call "
            "it; retunes flow controller -> scheduler.apply_knobs, never "
            "the reverse",
        )

    def _fleet_import(self, node: ast.AST, what: str) -> None:
        self._emit(
            "fleet-import", node,
            f"tick-path module imports the fleet observability plane "
            f"({what}) — the collector thread does socket I/O and is "
            "excluded from HOT_PATHS precisely because nothing on the "
            "tick path may call it; attachment is duck-typed "
            "(Router.attach_fleet), wired by the launcher/bench",
        )

    def visit_Import(self, node: ast.Import) -> None:
        if self.hot_names is not None:
            for alias in node.names:
                if _CONTROLLER_MODULE in alias.name:
                    self._controller_import(node, alias.name)
                if _FLEET_MODULE in alias.name \
                        and self.relpath != "telemetry/fleet.py":
                    self._fleet_import(node, alias.name)
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if (node.module or "").startswith("torch.distributed") and not self._dist_allowed():
            hits = [a.name for a in node.names if a.name in _DIST_COLLECTIVES]
            if hits:
                self._emit("raw-dist-collective", node,
                           f"torch.distributed.{hits[0]} imported outside comm/ — route "
                           "through comm.qcomm")
        if self.hot_names is not None:
            mod = node.module or ""
            if _CONTROLLER_MODULE in mod:
                self._controller_import(node, mod)
            elif mod == "autotuning" or mod.endswith(".autotuning") \
                    or (node.level > 0 and mod == "autotuning"):
                hits = [a.name for a in node.names
                        if a.name in _CONTROLLER_NAMES or a.name == "controller"]
                if hits:
                    self._controller_import(node, f"{mod}.{hits[0]}")
            if self.relpath != "telemetry/fleet.py":
                if _FLEET_MODULE in mod:
                    self._fleet_import(node, mod)
                elif mod == "telemetry" or mod.endswith(".telemetry") \
                        or (node.level > 0 and mod == "telemetry"):
                    hits = [a.name for a in node.names
                            if a.name in _FLEET_NAMES or a.name == "fleet"]
                    if hits:
                        self._fleet_import(node, f"{mod}.{hits[0]}")
        self.generic_visit(node)

    # -- rule: host sync in hot paths --------------------------------------
    def visit_Call(self, node: ast.Call) -> None:
        if self._in_hot_path():
            fn = node.func
            if isinstance(fn, ast.Attribute):
                if (fn.attr in _HOST_SYNC_ATTRS or fn.attr in _HOST_SYNC_FUNCS) \
                        and not self._sync_allowed(fn.attr):
                    self._emit(
                        "host-sync", node,
                        f".{fn.attr}() in hot path "
                        f"{'/'.join(self.func_stack)} — forces a device "
                        "round trip per call; fetch once per tick at the "
                        "designed sync point (HOST_SYNC_ALLOWED)",
                    )
            elif isinstance(fn, ast.Name):
                if fn.id in _HOST_SYNC_FUNCS:
                    self._emit(
                        "host-sync", node,
                        f"{fn.id}() in hot path — device round trip",
                    )
                elif fn.id == "float" and node.args and isinstance(
                        node.args[0], (ast.Call, ast.Subscript, ast.Attribute)):
                    # float(expr) on a computed value is the classic hidden
                    # blocking fetch; float(name)/float(literal) stay legal
                    self._emit(
                        "host-sync", node,
                        "float(<computed expr>) in hot path — if the operand "
                        "is a device array this blocks on it; hoist the "
                        "fetch to the tick's single sync point",
                    )
        self.generic_visit(node)

    def _sync_allowed(self, attr: str) -> bool:
        for name in self.func_stack:
            allowed = HOST_SYNC_ALLOWED.get((self.relpath, name), ())
            if attr in allowed:
                self.allowed_hits.add((self.relpath, name, attr))
                return True
        return False

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self.func_stack.append(node.name)
        self.generic_visit(node)
        self.func_stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef  # type: ignore[assignment]


def _visit(source: str, relpath: str) -> _Visitor:
    v = _Visitor(relpath, source.splitlines())
    v.visit(ast.parse(source))
    return v


def lint_source(source: str, relpath: str) -> List[LintViolation]:
    """Lint one module's source as ``relpath`` (the key space of the tables
    above) — the seeded-regression seam."""
    return _visit(source, relpath).out


def _package_files(root: str, exclude: Sequence[str]):
    for dirpath, _dirnames, filenames in os.walk(root):
        if "__pycache__" in dirpath:
            continue
        for fn in sorted(filenames):
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            rel = os.path.relpath(path, root).replace(os.sep, "/")
            if any(fnmatch.fnmatch(rel, pat) for pat in exclude):
                continue
            with open(path, encoding="utf-8") as fh:
                yield rel, fh.read()


def lint_package(root: Optional[str] = None,
                 exclude: Sequence[str] = ("analysis/*",)) -> List[LintViolation]:
    """Lint every ``.py`` under ``deepspeed_tpu_torch/`` (or ``root``).  The
    analysis package itself is excluded by default (its tables quote the
    forbidden names)."""
    out: List[LintViolation] = []
    for rel, src in _package_files(root or PKG_ROOT, exclude):
        out.extend(lint_source(src, rel))
    return out


def stale_exemptions(root: Optional[str] = None) -> List[str]:
    """Exemptions with nothing left to exempt: a ``HOST_SYNC_ALLOWED`` sync
    no longer called where it is listed, a ``GLOBAL_BASELINE`` global no
    longer rebound, or a ``HOT_PATHS`` function that no longer exists.  The
    tables may only shrink with the code."""
    root = root or PKG_ROOT
    hits: Set[Tuple[str, str, str]] = set()
    globals_seen: Set[Tuple[str, str]] = set()
    funcs: Dict[str, Set[str]] = {}
    for rel, src in _package_files(root, ("analysis/*",)):
        v = _visit(src, rel)
        hits |= v.allowed_hits
        tree = ast.parse(src)
        for node in ast.walk(tree):
            if isinstance(node, ast.Global):
                globals_seen |= {(rel, n) for n in node.names}
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                funcs.setdefault(rel, set()).add(node.name)
    out = []
    for (rel, fn), attrs in sorted(HOST_SYNC_ALLOWED.items()):
        out += [f"HOST_SYNC_ALLOWED {rel}:{fn} .{a}()" for a in sorted(attrs)
                if (rel, fn, a) not in hits]
    out += [f"GLOBAL_BASELINE {rel}:{name}" for rel, name in sorted(GLOBAL_BASELINE)
            if (rel, name) not in globals_seen]
    for rel, names in sorted(HOT_PATHS.items()):
        if rel not in funcs:
            out.append(f"HOT_PATHS {rel} (no such file)")
            continue
        out += [f"HOT_PATHS {rel}:{n}" for n in sorted(names - {"*"} - funcs[rel])]
    return out
