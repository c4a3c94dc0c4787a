"""vitcap_tpu_torch K11 (fused_vit_attn), K12 (tail_train) and the plain
chain's bf16 rounding vs the JAX package, on the CPU.

- fused_vit_attn / vit_attention_residual against vitcap_tpu/ops/
  fused_block.py:430 fused_vit_attn(interpret=True), values and gradients,
  on both sides of 1024 tokens (its q-tiles of 128 past it).  The JAX
  backward recomputes its plain chain, whose attention is the packed
  kernel under VITCAP_TRAIN_PALLAS=interpret, as the port's recompute
  takes the packed route.
- tail_train against :831 _tail_train_kernel, which no pallas_call of the
  JAX package reaches any more: the test wraps it in its own
  pl.pallas_call(interpret=True).
- F7: the bf16 GELU of the plain chain.  The JAX package's bf16 CPU trace
  of jax.nn.gelu(approximate=False) rounds inside the formula (erfc
  rounded to bf16, then 0.5 x times it rounded); the port's gelu is the
  f32 GELU rounded once, as its kernels' epilogues and the TPU kernels'
  _gelu_exact are.  The measured bit-equal fraction at each site is
  pinned below, and a bf16 train call of the plain chain is held to the
  JAX one.

Tolerances: f32 within 1e-4 of the reference's scale (gradients of each
leaf within 1e-4 of that leaf's scale); bf16 within 2e-2 of the scale and,
where both sides round at the same points, at least 99% of the values
bit-equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from vitcap_tpu.models import layers as JL
from vitcap_tpu.models import vitcap as JM
from vitcap_tpu.models.config import tiny_config as jax_tiny_config
from vitcap_tpu.ops import fused_block as JF

from vitcap_tpu_torch import ops
from vitcap_tpu_torch.models import config as TC
from vitcap_tpu_torch.models import layers as TL
from vitcap_tpu_torch.models import vitcap as TM
from vitcap_tpu_torch.ops import fused_block as TF
from vitcap_tpu_torch.solver import checkpoint_bridge as TB

B = 2
NH, HD = 2, 64
H = NH * HD


@pytest.fixture(autouse=True, scope="module")
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(autouse=True, scope="module")
def interpret():
    with pytest.MonkeyPatch.context() as m:
        m.setenv("VITCAP_TRAIN_PALLAS", "interpret")
        yield m


def _jdt(dtype):
    return jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32


def _j2t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(jnp.asarray(a, jnp.float32))).to(dtype)


def _bits(out, ref):
    return (out.detach().float() == ref.float()).float().mean().item()


def _agree(out, ref, dtype, bits=0.99):
    """f32: within 1e-4 of ref's scale (at least 1e-4); bf16: within 2e-2
    of it and at least `bits` of the values bit-equal."""
    ref = _j2t(ref, dtype)
    out = out.detach()
    assert out.shape == ref.shape
    scale = ref.float().abs().max().item()
    if dtype == torch.float32:
        tol = 1e-4 * max(1.0, scale)
    else:
        tol = 2e-2 * scale
        eq = _bits(out, ref)
        assert eq >= bits, eq
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= tol, (err, tol)


@pytest.fixture(scope="module")
def models():
    """A JAX param tree and the port model with the same weights, with
    non-zero biases and LayerNorm shifts so their gradients are tested."""
    kw = dict(hidden_size=H, intermediate_size=4 * H, num_attention_heads=NH)
    params = jax.tree_util.tree_map(
        np.array, JM.init_params(jax.random.PRNGKey(0),
                                   jax_tiny_config(**kw)))
    rs = np.random.RandomState(11)
    for path, a in TB.flatten_params(params).items():
        if path.endswith("bias"):
            a[...] = rs.randn(*a.shape).astype(np.float32) * 0.05
    model = TB.load_jax_params(TM.ViTCAP(TC.tiny_config(**kw)), params)
    return params, model


# ---------------------------------------------------------------------------
# K11: fused_vit_attn
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L", [72, 577, 1030])
def test_fused_vit_attn_matches_jax(models, L, dtype):
    """vit_attention_residual on the bridged ViTBlock against the JAX
    fused_vit_attn on the same block's params: the value (one-pass at L 72
    and 577, padded to 80 and 592 there; q-tiles of 128 at 1030, padded to
    1152), then the gradients of x and of every parameter through the
    recompute, each within the tolerance of its leaf's scale.  In bf16 the
    JAX trace sums the bias gradients (bqkv, bproj) in bf16 over the B * L
    rows, which puts them 2.8-4.4% of their scale off its own f32
    gradients at these sizes (the port's f32 sums: 0.26-0.35%); those two
    are held to the JAX f32 gradients."""
    params, model = models
    jp, p = params["encoder"]["blocks"][0], model.bert.encoder.blocks[0]
    rs = np.random.RandomState(L)
    x = rs.randn(B, L, H).astype(np.float32)
    g = rs.randn(B, L, H).astype(np.float32)
    leaves = (jp["norm1"]["scale"], jp["norm1"]["bias"],
              jp["attn"]["qkv"]["kernel"], jp["attn"]["qkv"]["bias"],
              jp["attn"]["proj"]["kernel"], jp["attn"]["proj"]["bias"])

    def jax_run(jdt):
        out, vjp = jax.vjp(
            lambda xx, *w: JF.fused_vit_attn(xx, *w, NH, 1e-6, True),
            jnp.asarray(x, jdt), *(jnp.asarray(a) for a in leaves))
        return out, [np.asarray(jnp.asarray(a, jnp.float32))
                     for a in vjp(jnp.asarray(g, jdt))]
    jout, jgrads = jax_run(_jdt(dtype))
    if dtype == torch.bfloat16:
        _, f32_grads = jax_run(jnp.float32)
        jgrads[4], jgrads[6] = f32_grads[4], f32_grads[6]

    p.requires_grad_(True)
    p.zero_grad(set_to_none=True)
    xt = torch.from_numpy(x).to(dtype).requires_grad_(True)
    out = TF.vit_attention_residual(p, xt, NH, 1e-6)
    assert out.dtype == dtype
    _agree(out, jout, dtype)
    out.backward(torch.from_numpy(g).to(dtype))
    got = [xt.grad, p.norm1.weight.grad, p.norm1.bias.grad,
           p.attn.qkv.weight.grad.t(), p.attn.qkv.bias.grad,
           p.attn.proj.weight.grad.t(), p.attn.proj.bias.grad]
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for name, gt, want in zip(("x", "lns", "lnb", "wqkv", "bqkv", "wproj",
                               "bproj"), got, jgrads):
        scale = max(float(np.abs(want).max()), 1e-3)
        np.testing.assert_allclose(gt.float().numpy(), want, rtol=0,
                                   atol=tol * scale, err_msg=name)
    p.requires_grad_(False)


def test_fused_vit_attn_is_the_block_attention_half(models):
    """fused_vit_block's output is fused_vit_attn's followed by the tail:
    the same composition, so the attention halves agree bit for bit (bf16,
    L 90); on CPU tensors the calls count no CUDA launch."""
    _, model = models
    p = model.bert.encoder.blocks[0]
    x = torch.from_numpy(np.random.RandomState(2).randn(B, 90, H)
                         .astype(np.float32)).bfloat16()
    ops.reset_counts()
    with torch.no_grad():
        half = TF.vit_attention_residual(p, x, NH, 1e-6)
        plain = TF.fused_vit_attn_plain(
            x, p.norm1.weight, p.norm1.bias, p.attn.qkv.weight,
            p.attn.qkv.bias, p.attn.proj.weight, p.attn.proj.bias, NH, 1e-6)
        out, y1, _ = TF.tail_train(x, torch.zeros_like(x), p.attn.proj.weight,
                                   p.attn.proj.bias, p.norm2.weight,
                                   p.norm2.bias, p.mlp.fc1.weight,
                                   p.mlp.fc1.bias, p.mlp.fc2.weight,
                                   p.mlp.fc2.bias, 1e-6)
    assert torch.equal(half, plain)
    assert y1.shape == out.shape == x.shape
    assert ops.call_counts() == {"fused_vit_attn": 0, "tail_train": 0}
    assert ops.launch_counts()["gemm"] == 0


# ---------------------------------------------------------------------------
# K12: tail_train
# ---------------------------------------------------------------------------

def _jax_tail_train(x, attn, p, eps):
    """_tail_train_kernel in its own pallas_call (interpret mode), the
    specs of _split_block_train_fwd's tail call."""
    Bn, Lp, Hn = x.shape
    dt = x.dtype
    In = p["mlp"]["fc1"]["kernel"].shape[1]
    row = lambda a: jnp.asarray(a).reshape(1, -1)
    vmem = pltpu.VMEM
    vec = lambda n: pl.BlockSpec((1, n), lambda b: (0, 0), memory_space=vmem)
    mat = lambda s: pl.BlockSpec(s, lambda b: (0, 0), memory_space=vmem)
    xspec = pl.BlockSpec((1, Lp, Hn), lambda b: (b, 0, 0), memory_space=vmem)
    ispec = pl.BlockSpec((1, Lp, In), lambda b: (b, 0, 0), memory_space=vmem)
    return pl.pallas_call(
        functools.partial(JF._tail_train_kernel, eps=eps),
        out_shape=(jax.ShapeDtypeStruct((Bn, Lp, Hn), dt),
                   jax.ShapeDtypeStruct((Bn, Lp, Hn), dt),
                   jax.ShapeDtypeStruct((Bn, Lp, In), dt)),
        grid=(Bn,),
        in_specs=[xspec, xspec, mat((Hn, Hn)), vec(Hn), vec(Hn), vec(Hn),
                  mat((Hn, In)), vec(In), mat((In, Hn)), vec(Hn)],
        out_specs=(xspec, xspec, ispec), interpret=True,
        compiler_params=pltpu.CompilerParams(
            vmem_limit_bytes=100 * 1024 * 1024),
    )(x, attn, jnp.asarray(p["attn"]["proj"]["kernel"]).astype(dt),
      row(p["attn"]["proj"]["bias"]), row(p["norm2"]["scale"]),
      row(p["norm2"]["bias"]),
      jnp.asarray(p["mlp"]["fc1"]["kernel"]).astype(dt),
      row(p["mlp"]["fc1"]["bias"]),
      jnp.asarray(p["mlp"]["fc2"]["kernel"]).astype(dt),
      row(p["mlp"]["fc2"]["bias"]))


class _Ref:
    """A kernel ref over a JAX array: reads index it, writes replace it."""

    def __init__(self, a):
        self.a = a

    def __getitem__(self, i):
        return self.a[i]

    def __setitem__(self, i, v):
        self.a = self.a.at[i].set(v)


def _jax_tail_train_as_written(x, attn, p, eps):
    """_tail_train_kernel's body run op by op, one image at a time: each
    astype rounds where the kernel writes it."""
    row = lambda a: _Ref(jnp.asarray(a).reshape(1, -1))
    mat = lambda a: _Ref(jnp.asarray(a).astype(x.dtype))
    outs = []
    for b in range(x.shape[0]):
        o = [_Ref(jnp.zeros((1,) + x.shape[1:], x.dtype)) for _ in range(2)]
        o.append(_Ref(jnp.zeros((1, x.shape[1],
                                 p["mlp"]["fc1"]["kernel"].shape[1]),
                                x.dtype)))
        JF._tail_train_kernel(
            _Ref(x[b:b + 1]), _Ref(attn[b:b + 1]),
            mat(p["attn"]["proj"]["kernel"]), row(p["attn"]["proj"]["bias"]),
            row(p["norm2"]["scale"]), row(p["norm2"]["bias"]),
            mat(p["mlp"]["fc1"]["kernel"]), row(p["mlp"]["fc1"]["bias"]),
            mat(p["mlp"]["fc2"]["kernel"]), row(p["mlp"]["fc2"]["bias"]), *o,
            eps=eps)
        outs.append([r.a for r in o])
    return [jnp.concatenate(parts) for parts in zip(*outs)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L", [80, 592])
def test_tail_train_matches_jax_kernel(models, L, dtype):
    """(out, y1, pre1) against _tail_train_kernel in its pallas_call: f32
    within 1e-4 of the scale, bf16 within 2e-2 of it.  In bf16 the
    interpret-mode run (which XLA compiles as one CPU program, keeping
    some intermediates above bf16) agrees on all of y1 but only on about
    52% of pre1 and 92% of out (measured at L 80); the same kernel body run
    op by op, rounding where it is written, agrees with the port on at
    least 99% of each output (the GELU is the exact erf where the kernel
    has the Abramowitz-Stegun form, |err| <= 1.5e-7)."""
    params, model = models
    jp, p = params["encoder"]["blocks"][0], model.bert.encoder.blocks[0]
    rs = np.random.RandomState(L + 1)
    x, attn = (rs.randn(B, L, H).astype(np.float32) for _ in range(2))
    jdt = _jdt(dtype)
    jx, ja = jnp.asarray(x, jdt), jnp.asarray(attn, jdt)
    refs = _jax_tail_train(jx, ja, jp, 1e-6)
    with torch.no_grad():
        got = TF.tail_train(torch.from_numpy(x).to(dtype),
                            torch.from_numpy(attn).to(dtype),
                            p.attn.proj.weight, p.attn.proj.bias,
                            p.norm2.weight, p.norm2.bias, p.mlp.fc1.weight,
                            p.mlp.fc1.bias, p.mlp.fc2.weight, p.mlp.fc2.bias,
                            1e-6)
    assert got[2].shape == (B, L, 4 * H)
    for out, ref in zip(got, refs):
        _agree(out, ref, dtype, bits=0.0)
    if dtype == torch.bfloat16:
        for out, ref in zip(got, _jax_tail_train_as_written(jx, ja, jp,
                                                            1e-6)):
            _agree(out, ref, dtype)


def test_tail_train_refuses_grad(models):
    """JAX defines no VJP for the tail kernel: under grad with an input
    that requires grad the port raises instead of dropping the
    gradient."""
    _, model = models
    p = model.bert.encoder.blocks[0]
    x = torch.zeros(B, 80, H, requires_grad=True)
    w = (p.attn.proj.weight, p.attn.proj.bias, p.norm2.weight, p.norm2.bias,
         p.mlp.fc1.weight, p.mlp.fc1.bias, p.mlp.fc2.weight, p.mlp.fc2.bias)
    with pytest.raises(RuntimeError, match="no backward"):
        TF.tail_train(x, torch.zeros(B, 80, H), *w, 1e-6)
    with torch.no_grad():
        assert TF.tail_train(x, torch.zeros(B, 80, H), *w, 1e-6)[0].shape \
            == x.shape


# ---------------------------------------------------------------------------
# F7: the plain chain's bf16 GELU
# ---------------------------------------------------------------------------

# the four sites of the plain chain's GELU: (name, JAX dense params path,
# the port module's dotted name); the measured bit-equal fraction of the
# port's gelu(dense(.)) against the JAX package's jitted one (bf16, CPU,
# LayerNorm-scaled inputs at H 128)
GELU_SITES = [
    ("vit_mlp", "encoder/blocks/0/mlp/fc1", 0.725),
    ("_bert_layer_plain", "decoder/layer/0/intermediate/dense", 0.726),
    ("lm_head_transform", "cls/transform/dense", 0.725),
    ("decode layer", "decoder/layer/1/intermediate/dense", 0.729),
]


@pytest.mark.parametrize("site,path,measured", GELU_SITES)
def test_bf16_gelu_sites_pinned(models, site, path, measured):
    """F7, pinned: at each site the port's bf16 GELU is the f32 GELU
    rounded once (bit for bit), and the JAX package's jitted bf16 trace
    agrees with it on `measured` of the values (within 0.03; below 0.99,
    so a change of either side's rounding shows here), the rest within
    2e-2 of the scale.  The dense products agree on at least 99.9%, so the
    difference is the GELU's internal rounding."""
    params, model = models
    jp = params
    for key in path.split("/"):
        jp = jp[int(key)] if key.isdigit() else jp[key]
    name, _ = TB.jax_path_to_torch_name(path + "/kernel")
    mod = model.get_submodule(name.rsplit(".", 1)[0])
    rs = np.random.RandomState(len(site))
    x = rs.randn(4, 64, H).astype(np.float32)
    x = (x - x.mean(-1, keepdims=True)) / x.std(-1, keepdims=True)
    xb = jnp.asarray(x, jnp.bfloat16)
    jref = jax.jit(lambda pp, a: JL.gelu(JL.dense(pp, a)))(jp, xb)
    ref = _j2t(jref, torch.bfloat16)
    dense_ref = _j2t(JL.dense(jp, xb), torch.bfloat16)
    with torch.no_grad():
        pre = TL.dense(mod, torch.from_numpy(x).bfloat16())
        out = TL.gelu(pre)
    assert _bits(pre, dense_ref) >= 0.999
    assert torch.equal(out, torch.nn.functional.gelu(pre.float()).bfloat16())
    eq = _bits(out, ref)
    assert measured - 0.03 <= eq < 0.99, eq
    _agree(out, jref, torch.bfloat16, bits=0.0)


def test_bf16_plain_chain_matches_jax(models):
    """A bf16 train call of the plain chain (vit_block at the unaligned
    L 90: the packed attention on both sides) against JAX: the output and
    the input gradient within 2e-2 of their scale; the output at least 90%
    bit-equal (measured 0.938: the GELU of F7 is the one rounding that
    differs)."""
    params, model = models
    jp, p = params["encoder"]["blocks"][0], model.bert.encoder.blocks[0]
    x = np.random.RandomState(3).randn(B, 90, H).astype(np.float32)

    def jloss(pp, xx):
        o = JL.vit_block(pp, xx, NH, 1e-6)
        return jnp.sum(o.astype(jnp.float32) ** 2), o
    (_, jout), (_, jgx) = jax.value_and_grad(jloss, argnums=(0, 1),
                                             has_aux=True)(
        jp, jnp.asarray(x, jnp.bfloat16))
    p.requires_grad_(True)
    xt = torch.from_numpy(x).bfloat16().requires_grad_(True)
    out = TL.vit_block(p, xt, NH, 1e-6)
    (out.float() ** 2).sum().backward()
    p.requires_grad_(False)
    _agree(out, jout, torch.bfloat16, bits=0.90)
    _agree(xt.grad, jgx, torch.bfloat16, bits=0.0)
