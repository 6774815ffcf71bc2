"""The ``compile`` section and the kernels as ``torch.library`` ops under
``torch.compile``, on the CPU (fp32, where every op runs its plain
version).

- The section's semantics against JAX's ``CompileConfig`` and JAX's
  ``tests/test_config_wiring.py:154`` probe: backend "xla" (JAX's default)
  runs eager here, where JAX jits; a torch backend compiles; ``disable`` or
  ``enabled: false`` runs eager; other backends, unknown ``kwargs`` keys
  and CUDA-graph replays are ``ConfigError`` at parse time.
- The model loss on ``tiny`` (2 layers, flash attention, selective remat)
  under ``torch.compile(backend="aot_eager", fullgraph=True)``: no graph
  break, the graph calls ``dstpu::flash_fwd`` (and its backward op), loss
  and gradients equal eager (tolerance 1e-6 absolute: the same plain ops in
  the same order, so equal to the bit or nearly).
- An engine trajectory compiled against its eager twin (3 steps, GAS 2),
  losses and masters at 1e-6.
- A block-sparse layout (``fixed``, head dim 64, s 256: K7's ops) under
  ``fullgraph``; the ops' registrations (``torch.library.opcheck``); a
  double backward through either op still raises; one ``inductor`` test
  (the C++ backend here: it needs ``g++``).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
from deepspeed_tpu.config.config import parse_config as j_parse_config
from deepspeed_tpu.models import CausalLM as JCausalLM
from deepspeed_tpu.models import get_preset as j_preset
from deepspeed_tpu.parallel.topology import initialize_mesh

import deepspeed_tpu_torch as tds
from deepspeed_tpu_torch.config.config import ConfigError, parse_config
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.models.presets import get_preset
from deepspeed_tpu_torch.ops.kernels import flash_attention as F1
from deepspeed_tpu_torch.ops.kernels import sparse_attention as K7
from deepspeed_tpu_torch.ops.sparse_attention import FixedSparsityConfig, block_sparse_attention

TOL = 1e-6
BASE = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
        "optimizer": {"type": "adamw", "params": {"lr": 1e-3}}, "bf16": {"enabled": False},
        "steps_per_print": 1000}
DSTPU_OPS = {"dstpu.flash_fwd.default", "dstpu.flash_bwd.default", "dstpu.sparse_fwd.default",
             "dstpu.sparse_bwd.default"}


@pytest.fixture(autouse=True)
def fresh_dynamo():
    """Each test compiles ``CausalLM.loss_fn`` anew: one test's guards
    (another model, another engine) never count toward the next one's
    recompile limit."""
    torch._dynamo.reset()
    yield
    torch._dynamo.reset()


class Recorder:
    """A ``torch.compile`` backend that keeps each forward / backward graph's
    call targets and runs them as aot_eager does."""

    def __init__(self):
        from functorch.compile import make_boxed_func
        from torch._dynamo.backends.common import aot_autograd

        self.targets = []

        def keep(gm, _inputs):
            self.targets.append({str(n.target) for n in gm.graph.nodes
                                 if n.op == "call_function"})
            return make_boxed_func(gm.forward)

        self.backend = aot_autograd(fw_compiler=keep, bw_compiler=keep)

    def ops(self):
        return [t & DSTPU_OPS for t in self.targets]


# ---------------------------------------------------------------------------
# the section
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("section,compiles", [
    (None, False), ({"backend": "xla"}, False), ({"enabled": False}, False),
    ({"disable": True}, False), ({"backend": "inductor"}, True),
    ({"backend": "aot_eager", "kwargs": {"fullgraph": True, "dynamic": False}}, True),
    ({"backend": "eager"}, True), ({"backend": "inductor", "enabled": False}, False),
    ({"backend": "inductor", "disable": True}, False),
    ({"backend": "inductor", "kwargs": {"mode": "max-autotune-no-cudagraphs"}}, True),
])
def test_section_parses_as_jax_and_decides_compilation(section, compiles):
    raw = {} if section is None else {"compile": section}
    t, j = parse_config(raw, 1), j_parse_config(raw, dp_world_size=1)
    assert dataclasses.asdict(t.compile) == dataclasses.asdict(j.compile)
    assert t.compile.compiles is compiles


@pytest.mark.parametrize("section,match", [
    ({"backend": "tvm"}, "compile.backend"), ({"backend": "cudagraphs"}, "CUDA-graph replay"),
    ({"backend": "inductor", "kwargs": {"mode": "reduce-overhead"}}, "CUDA-graph replay"),
    ({"backend": "inductor", "kwargs": {"mode": "max-autotune"}}, "CUDA-graph replay"),
    ({"backend": "inductor", "kwargs": {"options": {"triton.cudagraphs": True}}},
     "CUDA-graph replay"),
    ({"backend": "inductor", "kwargs": {"full_graph": True}}, "compile.kwargs"),
    ({"backend": "aot_eager", "bogus": 1}, "unknown config key 'bogus'"),
])
def test_section_refusals_are_config_errors(section, match):
    with pytest.raises(ConfigError, match=match):
        parse_config({"compile": section})


def test_jit_probe_against_jax():
    """JAX's ``test_compile_disable_runs_eager`` probe: ``_jit`` returns the
    function itself when nothing compiles.  JAX jits at its default
    ("xla"); the port runs eager there and compiles under a torch backend."""
    probe = lambda x: x  # noqa: E731
    jmesh = initialize_mesh(devices=jax.devices()[:1], data=1)
    jcfg = j_preset("tiny", num_layers=2)
    jdefault = jds.initialize(model=JCausalLM(jcfg), config=BASE, mesh=jmesh)[0]
    jdisabled = jds.initialize(model=JCausalLM(jcfg), config=dict(BASE, compile={"disable": True}),
                               mesh=jmesh)[0]
    assert jdefault._jit(probe) is not probe and jdisabled._jit(probe) is probe
    cfg = get_preset("tiny", dtype=torch.float32, num_layers=2)

    def engine(section):
        raw = dict(BASE) if section is None else dict(BASE, compile=section)
        return tds.initialize(model=tt.CausalLM(cfg), config=raw, device="cpu")[0]

    assert engine(None)._jit(probe) is probe  # "xla": eager, unlike JAX
    assert engine({"disable": True})._jit(probe) is probe
    assert engine({"backend": "aot_eager", "enabled": False})._jit(probe) is probe
    compiled = engine({"backend": "aot_eager"})
    assert compiled._jit(probe) is not probe
    assert compiled._model_loss() is not compiled.loss_fn
    with pytest.raises(ConfigError, match="progressive_layer_drop"):
        tds.initialize(model=tt.CausalLM(cfg), device="cpu", config=dict(
            BASE, compile={"backend": "aot_eager"},
            progressive_layer_drop={"enabled": True}))


# ---------------------------------------------------------------------------
# the compiled loss and step
# ---------------------------------------------------------------------------
def _tiny(**kw):
    return get_preset("tiny", dtype=torch.float32, max_seq_len=64, attn_impl="flash",
                      remat="selective", num_layers=2, **kw)


def _leaves(tree):
    return [v for k in sorted(tree) for v in (_leaves(tree[k]) if isinstance(tree[k], dict)
                                              else [tree[k]])]


def test_model_loss_compiles_fullgraph_through_the_ops():
    """One graph (``fullgraph=True``), the flash ops in its forward and
    backward graphs, the loss and every gradient equal to eager."""
    cfg = _tiny()
    model = tt.CausalLM(cfg)
    rng = np.random.default_rng(0)
    batch = {"input_ids": torch.as_tensor(rng.integers(0, 256, (2, 65)))}

    def grads(fn):
        params = tt.init_params(cfg, device="cpu")
        leaves = _leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        loss = fn(params, batch, torch.Generator().manual_seed(1))
        return loss.detach(), torch.autograd.grad(loss, leaves)

    rec = Recorder()
    compiled = torch.compile(model.loss_fn, backend=rec.backend, fullgraph=True)
    (l_c, g_c), (l_e, g_e) = grads(compiled), grads(model.loss_fn)
    torch.testing.assert_close(l_c, l_e, atol=TOL, rtol=0)
    for a, b in zip(g_c, g_e):
        torch.testing.assert_close(a, b, atol=TOL, rtol=0)
    assert rec.ops() == [{"dstpu.flash_fwd.default"}, {"dstpu.flash_bwd.default"}]


def test_compiled_engine_trajectory_equals_eager():
    cfg = _tiny()
    rng = np.random.default_rng(1)
    batches = [{"input_ids": rng.integers(0, 256, (2, 2, 65)).astype(np.int64)}
               for _ in range(3)]
    runs = {}
    for name, section in (("eager", None), ("compiled", {"backend": "aot_eager"})):
        raw = dict(BASE) if section is None else dict(BASE, compile=section)
        engine = tds.initialize(model=tt.CausalLM(cfg), params=tt.init_params(cfg, device="cpu"),
                                config=raw, device="cpu")[0]
        losses = [float(engine.train_batch(b)) for b in batches]
        runs[name] = (losses, engine._masters.flat.detach().clone())
    np.testing.assert_allclose(runs["compiled"][0], runs["eager"][0], atol=TOL, rtol=0)
    torch.testing.assert_close(runs["compiled"][1], runs["eager"][1], atol=TOL, rtol=0)


def test_sparse_layout_compiles_fullgraph_through_the_ops():
    """``fixed`` at head dim 64 and s 256 (K7's ops; the tables a constant
    of the trace), then a model with the layout: one graph each, equal to
    eager."""
    layout = FixedSparsityConfig(block=128, num_local_blocks=1, num_global_blocks=1)
    torch.manual_seed(0)
    q, k, v = (torch.randn(1, 256, h, 64, requires_grad=True) for h in (4, 2, 2))

    def attn(q, k, v):
        return (block_sparse_attention(q, k, v, layout, logits_soft_cap=5.0) ** 2).sum()

    rec = Recorder()
    got = torch.autograd.grad(torch.compile(attn, backend=rec.backend, fullgraph=True)(q, k, v),
                              (q, k, v))
    want = torch.autograd.grad(attn(q, k, v), (q, k, v))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=TOL, rtol=0)
    assert rec.ops() == [{"dstpu.sparse_fwd.default"}, {"dstpu.sparse_bwd.default"}]
    cfg = get_preset("tiny", dtype=torch.float32, max_seq_len=256, num_heads=1,
                     num_kv_heads=1, num_layers=2)
    engine_cfg = dict(BASE, sparse_attention={"mode": "fixed", "block": 128,
                                              "num_local_blocks": 1, "num_global_blocks": 1})
    rng = np.random.default_rng(2)
    batches = [{"input_ids": rng.integers(0, 256, (2, 2, 257)).astype(np.int64)}
               for _ in range(2)]
    losses = {}
    for name, section in (("eager", None), ("compiled", {"backend": "aot_eager",
                                                         "kwargs": {"fullgraph": True}})):
        raw = engine_cfg if section is None else dict(engine_cfg, compile=section)
        engine = tds.initialize(model=tt.CausalLM(cfg), params=tt.init_params(cfg, device="cpu"),
                                config=raw, device="cpu")[0]
        losses[name] = [float(engine.train_batch(b)) for b in batches]
    np.testing.assert_allclose(losses["compiled"], losses["eager"], atol=TOL, rtol=0)


def test_importing_the_port_leaves_dynamo_unimported():
    """The model, engine and serving modules import no ``torch._dynamo`` /
    ``torch._inductor`` (seconds in every process, each subprocess worker
    included); the sparse layout's builders carry dynamo's constant mark,
    the one ``torch.compiler.assume_constant_result`` sets."""
    import os
    import subprocess
    import sys

    from deepspeed_tpu_torch.ops import sparse_attention as tsa

    code = ("import sys, torch, deepspeed_tpu_torch, deepspeed_tpu_torch.runtime.engine, "
            "deepspeed_tpu_torch.serving.pool, deepspeed_tpu_torch.inference.engine_v2; "
            "print(sorted(m for m in ('torch._dynamo', 'torch._inductor') if m in sys.modules))")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True,
                         text=True, check=True, env={**os.environ, "PYTHONPATH": repo})
    assert out.stdout.strip() == "[]", out.stdout + out.stderr

    mark = vars(torch.compiler.assume_constant_result(lambda: None))
    assert mark and all(getattr(f, k, None) == v for f in (tsa._plan_tables, tsa._dense_mask)
                        for k, v in mark.items())


def _plan_args(s=256, block=128):
    plan = K7.sparse_plan(np.tril(np.ones((s // block,) * 2, bool)), block, True, "cpu")
    return (*plan.tables, block)


def test_the_ops_registrations_pass_opcheck():
    """Schema, fake (shapes, dtypes, strides) and autograd registration of
    the four ops, on small fp32 CPU inputs with segment ids and a soft cap."""
    torch.manual_seed(0)
    q, k, v = (torch.randn(1, 128, h, 64, requires_grad=True) for h in (2, 1, 1))
    seg = torch.tensor([[0] * 50 + [1] * 78], dtype=torch.int32)
    o, lse = torch.ops.dstpu.flash_fwd(q, k, v, seg, 0.125, 5.0)
    do = torch.randn_like(o)
    tables = _plan_args(128, 64)
    so, slse = torch.ops.dstpu.sparse_fwd(q, k, v, seg, seg, *tables, 0.125, None)
    detached = [t.detach() for t in (q, k, v, o, lse, so, slse)]
    cases = [
        (torch.ops.dstpu.flash_fwd.default, (q, k, v, seg, 0.125, 5.0)),
        (torch.ops.dstpu.flash_bwd.default, (*detached[:3], seg, *detached[3:5], do, 0.125, 5.0)),
        (torch.ops.dstpu.sparse_fwd.default, (q, k, v, seg, seg, *tables, 0.125, None)),
        (torch.ops.dstpu.sparse_bwd.default, (*detached[:3], seg, seg, *detached[5:7], do,
                                              *tables, 0.125, None)),
    ]
    for op, args in cases:
        torch.library.opcheck(op, args, test_utils=("test_schema", "test_autograd_registration",
                                                    "test_faketensor"))


@pytest.mark.parametrize("which", ["flash", "sparse"])
def test_double_backward_through_the_ops_raises(which):
    torch.manual_seed(0)
    q, k, v = (torch.randn(1, 256, 2, 64, requires_grad=True) for _ in range(3))

    def attn(q, k, v):
        if which == "flash":
            return torch.ops.dstpu.flash_fwd(q, k, v, None, 0.125, None)[0]
        return torch.ops.dstpu.sparse_fwd(q, k, v, None, None, *_plan_args(), 0.125, None)[0]

    g, = torch.autograd.grad((attn(q, k, v) ** 2).sum(), q, create_graph=True)
    with pytest.raises(RuntimeError, match="differentiate twice"):
        torch.autograd.grad((g * torch.randn_like(g)).sum(), q)


def test_inductor_calls_the_flash_op():
    """The one ``inductor`` test: the generated code calls the op (never a
    generated attention), and the result and gradients equal eager."""
    from torch._inductor.utils import run_and_get_code

    torch.manual_seed(0)
    q, k, v = (torch.randn(1, 128, h, 64, requires_grad=True) for h in (4, 2, 2))

    def f(q, k, v):
        return (F1.flash_attention(q * 2.0, k, v, logits_soft_cap=5.0) ** 2).sum()

    compiled = torch.compile(f, backend="inductor", fullgraph=True)
    out, codes = run_and_get_code(lambda: torch.autograd.grad(compiled(q, k, v), (q, k, v)))
    want = torch.autograd.grad(f(q, k, v), (q, k, v))
    for a, b in zip(out, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    assert any("torch.ops.dstpu.flash_fwd.default" in c for c in codes)
    assert any("torch.ops.dstpu.flash_bwd.default" in c for c in codes)
