"""The blocks' epilogue (bias, BatchNorm, activation) as one autograd
Function, ``kernels.block_epilogue``, against the chain of torch ops the
blocks ran before it, kept here as the oracle and differentiated by
autograd.

On the CPU: the plain Function's forward equals the chain bit for bit;
its closed-form backward equals autograd through the chain to 1e-10 in
float64, and in bfloat16 keeps the chain's rounding points, so it equals
it to 1e-6; the gradients against the JAX packed block's (the one test
that imports JAX, inside it); the running statistics move once, and not in
a remat recompute; a clamped variance passes no gradient.  Tests marked
``cuda`` hold the kernels against the plain Function on the card and skip
here:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_block_epilogue.py -m cuda
"""
import copy
import importlib
from unittest import mock

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deepatlas_torch import kernels
from deepatlas_torch.kernels import block_epilogue, block_epilogue_plain
from deepatlas_torch.kernels.block_epilogue import (MAX_PARTS, VAR_PRE,
                                                    _forward_math, _Spec,
                                                    _voxel_stride, layout)
from deepatlas_torch.models import layers

# the module (its name is shadowed on the package by the wrapper's)
EPILOGUE = importlib.import_module("deepatlas_torch.kernels.block_epilogue")
ACTS = ("LeakyReLU", "ReLU", "None")
MODES = ("none", "train", "eval")       # no BatchNorm, train, eval
VOXELS = (0, 1, 2, 3)


def chain(y, bias, bn, act, train, update=True):
    """The epilogue as ``_Block._forward`` and ``BatchNorm.forward`` ran it
    in torch ops (the float32 moments widened to float64 for a float64
    input)."""
    dt = y.dtype
    x = y if bias is None else y + bias.to(dt)
    if bn is not None:
        if train:
            xf = x.to(torch.promote_types(dt, torch.float32))
            mean = xf.mean(dim=VOXELS)
            var = ((xf * xf).mean(dim=VOXELS) - mean * mean).clamp(min=0.0)
            if update:
                with torch.no_grad():
                    bn.running_mean.mul_(bn.momentum).add_(
                        mean, alpha=1 - bn.momentum)
                    bn.running_var.mul_(bn.momentum).add_(
                        var, alpha=1 - bn.momentum)
        else:
            mean, var = bn.running_mean, bn.running_var
        mul = bn.weight * torch.rsqrt(var + bn.eps)
        add = bn.bias - mean * mul
        x = x * mul.to(dt) + add.to(dt)
    return {"ReLU": F.relu,
            "LeakyReLU": lambda t: F.leaky_relu(t, negative_slope=0.01),
            "None": lambda t: t}[act](x)


def make_case(c, mode, dtype, seed=230, shape=(2, 5, 6, 7)):
    """y, bias, a BatchNorm (or None) with drawn parameters and running
    statistics, and an upstream gradient."""
    rng = np.random.RandomState(seed)
    pdt = torch.float64 if dtype == torch.float64 else torch.float32

    def t(a, dt=pdt):
        return torch.from_numpy(np.asarray(a, np.float64)).to(dt)

    y = t(rng.randn(*shape, c) * 1.5 + 0.4, dtype)
    bias = t(0.3 * rng.randn(c))
    bn = None
    if mode != "none":
        bn = layers.BatchNorm(c).to(pdt)
        with torch.no_grad():
            bn.weight.copy_(t(1 + 0.3 * rng.randn(c)))
            bn.bias.copy_(t(0.3 * rng.randn(c)))
            bn.running_mean.copy_(t(0.2 * rng.randn(c)))
            bn.running_var.copy_(t(rng.uniform(0.5, 1.5, c)))
    g = t(rng.randn(*shape, c), dtype)
    return y, bias, bn, g


def run(fn, y, bias, bn, g, act, train, update=True):
    """Output, gradients of y, the bias, the scale and the shift, and the
    running statistics after one differentiated call of ``fn``."""
    bn = copy.deepcopy(bn)
    yy = y.clone().requires_grad_()
    bb = bias.clone().requires_grad_()
    out = fn(yy, bb, bn, act, train, update)
    out.backward(g)
    grads = [yy.grad, bb.grad]
    stats = []
    if bn is not None:
        grads += [bn.weight.grad, bn.bias.grad]
        stats = [bn.running_mean, bn.running_var]
    return out.detach(), grads, stats


def function(y, bias, bn, act, train, update=True):
    return block_epilogue(y, bias, bn, act, train, update_stats=update)


# ------------------------------------------------------------- forward

@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("c", [3, 8, 16, 64])
def test_forward_equals_chain_bit_for_bit(c, mode, act):
    """bfloat16, train and eval, with and without BatchNorm: the output and
    the running statistics are the chain's bits."""
    y, bias, bn, _ = make_case(c, mode, torch.bfloat16, seed=c)
    train = mode == "train"
    bn_k, bn_c = copy.deepcopy(bn), copy.deepcopy(bn)
    got = block_epilogue(y, bias, bn_k, act, train)
    want = chain(y, bias, bn_c, act, train)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    if bn is not None:
        assert torch.equal(bn_k.running_mean, bn_c.running_mean)
        assert torch.equal(bn_k.running_var, bn_c.running_var)
        moved = not torch.equal(bn_k.running_mean, bn.running_mean)
        assert moved == train


@pytest.mark.parametrize("mode", MODES)
def test_forward_float32_equals_chain(mode):
    y, bias, bn, _ = make_case(16, mode, torch.float32)
    got = block_epilogue(y, bias, copy.deepcopy(bn), "LeakyReLU",
                         mode == "train")
    want = chain(y, bias, copy.deepcopy(bn), "LeakyReLU", mode == "train")
    assert torch.equal(got, want)


def test_batchnorm_module_and_block_run_the_function():
    """``BatchNorm.forward`` is the epilogue without bias or activation,
    ``ConvBlock`` the conv followed by the whole epilogue."""
    y, bias, bn, _ = make_case(8, "train", torch.bfloat16)
    got = copy.deepcopy(bn)(y, train=True)
    assert torch.equal(got, chain(y, None, copy.deepcopy(bn), "None", True))
    torch.manual_seed(0)
    blk = layers.ConvBlock(4, 8, batchnorm=True, act="LeakyReLU")
    x = torch.rand(1, 4, 6, 6, 4).to(torch.bfloat16)
    ref_bn = copy.deepcopy(blk.bn)
    out = blk(x, train=True)
    conv = kernels.conv3d_k3(x, blk.weight)
    assert torch.equal(out, chain(conv, blk.bias, ref_bn, "LeakyReLU", True))
    assert torch.equal(blk.bn.running_var, ref_bn.running_var)


# ------------------------------------------------------------ backward

def rel_err(a, b, scale=None):
    a, b = a.double(), b.double()
    scale = b.abs().max().item() if scale is None else scale
    return (a - b).abs().max().item() / max(scale, 1e-300)


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("mode", MODES)
def test_closed_form_backward_float64(mode, act):
    """The closed-form gradients against autograd through the chain, in
    float64, to 1e-10 of each gradient's largest entry.  The bias in front
    of a train-mode BatchNorm has a gradient that cancels to rounding
    noise; it is held against the size of the terms that cancel."""
    y, bias, bn, g = make_case(8, mode, torch.float64)
    train = mode == "train"
    out_k, grads_k, stats_k = run(function, y, bias, bn, g, act, train)
    out_c, grads_c, stats_c = run(chain, y, bias, bn, g, act, train)
    assert torch.equal(out_k, out_c)
    for a, b in zip(stats_k, stats_c):
        assert torch.equal(a, b)
    names = ("dy", "dbias", "dweight", "dshift")
    for name, a, b in zip(names, grads_k, grads_c):
        scale = None
        if name == "dbias" and train:
            scale = g.abs().sum(dim=VOXELS).max().item()
        assert rel_err(a, b, scale) <= 1e-10, name


@pytest.mark.parametrize("act", ["LeakyReLU", "ReLU"])
@pytest.mark.parametrize("mode", MODES)
def test_closed_form_backward_bfloat16(mode, act):
    """bfloat16: the Function rounds where autograd through the chain
    rounds (dz, the per-channel sums, each of dx's two paths and their sum,
    the bias's sum of dx), so the gradients equal the chain's but for the
    float32 order of the per-channel coefficients, which may flip a
    rounding of an entry near 0: each to 1e-6 of its largest entry (the
    bias in front of a train-mode BatchNorm, a sum of dx near 0, of the sum
    of |g|)."""
    y, bias, bn, g = make_case(16, mode, torch.bfloat16)
    train = mode == "train"
    _, grads_k, _ = run(function, y, bias, bn, g, act, train)
    _, grads_c, _ = run(chain, y, bias, bn, g, act, train)
    for name, a, b in zip(("dy", "dbias", "dweight", "dshift"), grads_k,
                          grads_c):
        scale = None
        if name == "dbias" and train:
            scale = g.float().abs().sum(dim=VOXELS).max().item()
        assert rel_err(a, b, scale) <= 1e-6, name


def jax_packed_block_grads(y, bias, bn, g, act, train):
    """Gradients of sum(g * block epilogue) in y, the bias, the BatchNorm's
    scale and shift, as the JAX packed conv block forms them after its conv
    (``PackedConvBlock``: the tiled bias in y's type, ``PackedBatchNorm``,
    the activation) on the channel-last volume packed as (B, D, H, W * C)."""
    import jax
    import jax.numpy as jnp

    from deepatlas_tpu.models.layers import get_activation
    from deepatlas_tpu.models.packed import PackedBatchNorm

    b, d, h, w, c = y.shape
    f64 = y.dtype == torch.float64
    dt, pdt = ((jnp.float64, jnp.float64) if f64
               else (jnp.bfloat16, jnp.float32))

    def arr(t, dtype):
        return jnp.asarray(t.detach().double().numpy()).astype(dtype)

    params = {"scale": arr(bn.weight, pdt), "bias": arr(bn.bias, pdt)}
    stats = {"mean": arr(bn.running_mean, pdt),
             "var": arr(bn.running_var, pdt)}
    module = PackedBatchNorm(c, b * d * h * w, dtype=dt)
    gp = arr(g, pdt).reshape(b, d, h, w * c)

    def loss(yp, bp, params):
        x = yp + jnp.tile(bp, w).astype(dt)
        out, _ = module.apply({"params": params, "batch_stats": stats}, x,
                              train, mutable=["batch_stats"])
        return jnp.sum(get_activation(act)(out).astype(pdt) * gp)

    grads = jax.grad(loss, argnums=(0, 1, 2))(
        arr(y, dt).reshape(b, d, h, w * c), arr(bias, pdt), params)
    dy, db, dp = (jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a, np.float64)), t)
        for t in grads)
    return [dy.reshape(y.shape), db, dp["scale"], dp["bias"]]


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("mode", ["train", "eval"])
def test_gradients_match_jax_packed_block(mode, act):
    """The Function's gradients against ``jax.grad`` of the JAX packed
    block's epilogue on the same inputs, under ``jax.enable_x64``: dy and
    the scale's and shift's gradients to 1e-6 of their largest entry (the
    packed BatchNorm takes its moments in float32), the bias in front of a
    train-mode BatchNorm, whose gradient cancels to 0, to 1e-6 of the sum
    of |g|.  In bfloat16, with ReLU (the JAX leaky_relu's derivative at 0
    is 1, torch's 0.01, and a bf16 z is often exactly 0): dy, the scale's
    and the shift's gradients within 2e-2 of their largest entry, as
    ``test_torch_bn_loss.py`` holds the packed BatchNorm, since XLA sums
    the per-channel cotangents of the bf16 scale and shift in bf16.  The
    bias's bf16 gradient, a sum of dx near 0, is held against the chain
    (``test_closed_form_backward_bfloat16``): XLA's bf16 sums put JAX's
    as far from the exact (T(mul) - mul) Sg as that value's size."""
    import jax

    y, bias, bn, g = make_case(16, mode, torch.float64)
    train = mode == "train"
    with jax.enable_x64(True):
        want = jax_packed_block_grads(y, bias, bn, g, act, train)
    _, got, _ = run(function, y, bias, bn, g, act, train)
    for name, a, b in zip(("dy", "dbias", "dweight", "dshift"), got, want):
        scale = None
        if name == "dbias" and train:
            scale = g.abs().sum(dim=VOXELS).max().item()
        assert rel_err(a, b, scale) <= 1e-6, name
    if act != "ReLU":
        return
    y, bias, bn, g = make_case(16, mode, torch.bfloat16)
    want = jax_packed_block_grads(y, bias, bn, g, act, train)
    _, got, _ = run(function, y, bias, bn, g, act, train)
    for name, a, b in zip(("dy", "dweight", "dshift"), got[::2] + got[3:],
                          want[::2] + want[3:]):
        assert rel_err(a, b) <= 2e-2, name


def test_no_batchnorm_backward_equals_chain_bit_for_bit():
    """Without a BatchNorm dx is T(act'(z) g), the chain's bits."""
    for act in ACTS:
        y, bias, _, g = make_case(8, "none", torch.bfloat16)
        _, (dy_k, _), _ = run(function, y, bias, None, g, act, False)
        _, (dy_c, _), _ = run(chain, y, bias, None, g, act, False)
        assert torch.equal(dy_k, dy_c), act


def test_clamped_variance_passes_no_gradient():
    """A constant channel whose float32 E[x^2] - mean^2 falls below 0: the
    clamp's zero gradient, as autograd takes it, in both."""
    c = 4
    y, bias, bn, g = make_case(c, "train", torch.float32, seed=5)
    y[..., 1], bias[1] = 1.1, 0.0   # mean^2 rounds above E[x^2]
    spec = _Spec(copy.deepcopy(bn), "LeakyReLU", True, False, None, True)
    with torch.no_grad():
        _, stats = _forward_math(y, bias, bn.weight, bn.bias, spec)
    assert stats[VAR_PRE, 1] < 0 <= stats[VAR_PRE, 0]
    _, grads_k, _ = run(function, y, bias, bn, g, "LeakyReLU", True)
    _, grads_c, _ = run(chain, y, bias, bn, g, "LeakyReLU", True)
    for name, a, b in zip(("dy", "dweight", "dshift"), grads_k[::2] +
                          grads_k[3:], grads_c[::2] + grads_c[3:]):
        assert rel_err(a, b) <= 1e-5, name
    assert rel_err(grads_k[2], grads_c[2]) <= 1e-5


# ------------------------------------------------- running statistics

def test_running_stats_move_once_and_not_when_recomputing():
    y, bias, bn, g = make_case(8, "train", torch.bfloat16)
    bn0 = copy.deepcopy(bn)
    out = block_epilogue(y, bias, bn, "LeakyReLU", True)
    moved = bn.running_mean.clone(), bn.running_var.clone()
    assert not torch.equal(moved[0], bn0.running_mean)
    with layers._recompute():
        again = layers.BatchNorm.forward(bn, y + bias.to(y.dtype), True)
    assert torch.equal(bn.running_mean, moved[0])
    assert torch.equal(bn.running_var, moved[1])
    assert again.dtype == out.dtype


@pytest.mark.parametrize("batchnorm", [True, False])
def test_remat_block_equals_plain_bit_for_bit(batchnorm):
    """A remat ConvBlock recomputes its conv and the epilogue's forward
    (whose saved tensors are packed when its forward returns), moves the
    statistics once, and gives the plain block's gradients bit for bit."""
    torch.manual_seed(1)
    x0 = torch.rand(2, 6, 6, 6, 4).to(torch.bfloat16)
    out = {}
    for remat in (False, True):
        torch.manual_seed(2)
        blk = layers.ConvBlock(4, 8, batchnorm=batchnorm, act="LeakyReLU",
                               remat=remat)
        x = x0.clone().requires_grad_()
        calls = []

        def counted(*a, **k):
            calls.append(1)
            return _forward_math(*a, **k)

        with mock.patch.object(EPILOGUE, "_forward_math", counted):
            y = blk(x, train=True)
            (y.float() * torch.linspace(-1, 1, 8)).sum().backward()
        out[remat] = (y.detach(), x.grad, [p.grad for p in blk.parameters()],
                      [b.clone() for b in blk.buffers()], len(calls))
    (y0, dx0, gp0, st0, n0), (y1, dx1, gp1, st1, n1) = out[False], out[True]
    assert torch.equal(y0, y1) and torch.equal(dx0, dx1)
    assert all(torch.equal(a, b) for a, b in zip(gp0, gp1))
    assert all(torch.equal(a, b) for a, b in zip(st0, st1))
    assert (n0, n1) == (1, 2)


# ------------------------------------------------------------ helpers

@pytest.mark.parametrize("nvox,c,vec,rows,parts", [
    (10, 8, 8, 256, 1), (5_644_800, 8, 8, 256, MAX_PARTS),
    (11025, 64, 8, 32, 345), (11025, 512, 8, 4, MAX_PARTS),
    (100, 3, 1, 64, 2), (0, 16, 8, 128, 1)])
def test_layout(nvox, c, vec, rows, parts):
    assert layout(nvox, c, vec) == (rows, parts)


def test_layout_rejects_too_many_chunks():
    with pytest.raises(ValueError, match="exceed one block"):
        layout(10, 257, 1)


def test_voxel_stride_of_channel_slices():
    full = torch.zeros(2, 3, 4, 5, 24)
    assert _voxel_stride(full) == 24
    assert _voxel_stride(full[..., 8:16]) == 24
    assert _voxel_stride(full[:1, 1:]) == 24
    assert _voxel_stride(full[:, 1:]) is None      # batches apart
    assert _voxel_stride(full[:, :, ::2]) is None
    assert _voxel_stride(full.transpose(1, 2)) is None


def test_cpu_launches_no_kernel_and_rejects_bad_operands():
    y, bias, bn, g = make_case(8, "train", torch.bfloat16)
    kernels.reset_launch_counts()
    run(function, y, bias, bn, g, "LeakyReLU", True)
    assert kernels.launch_counts()["block_epilogue"] == 0
    with pytest.raises(NotImplementedError, match="activation"):
        block_epilogue(y, bias, None, "GELU")
    with pytest.raises(ValueError, match="bias must be"):
        block_epilogue(y, bias[:3], None, "ReLU")
    with pytest.raises(ValueError, match=r"\(B, D, H, W, C\)"):
        block_epilogue(y[0], None, None, "ReLU")
    # the conv census runs the model on the meta device: shapes only
    bn_meta = layers.BatchNorm(8).to("meta")
    meta = torch.empty(1, 2, 2, 2, 8, device="meta", dtype=torch.bfloat16)
    out = block_epilogue(meta, None, bn_meta, "ReLU", True)
    assert out.shape == meta.shape and out.device.type == "meta"


# ---------------------------------------------------------------- card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


# the seg step's and a serving tile batch's block shapes (first level and
# the deepest), the fixed UNet's widest at its deepest level, an odd voxel
# count, and a channel count that takes the scalar path
CARD_SHAPES = [(1, 168, 200, 168, 8), (1, 21, 25, 21, 64),
               (4, 128, 128, 128, 8), (4, 16, 16, 16, 64),
               (1, 21, 25, 21, 512), (1, 7, 9, 11, 16), (2, 5, 7, 9, 3)]


def card_case(shape, mode, dtype, cuda, seed=7):
    y, bias, bn, g = make_case(shape[-1], mode, torch.float32, seed=seed,
                               shape=shape[:-1])
    y, g = y.to(cuda, dtype), g.to(cuda, dtype)
    bias = bias.to(cuda)
    if bn is not None:
        bn = bn.to(cuda)
    return y, bias, bn, g


def plain(y, bias, bn, act, train, update=True):
    return block_epilogue_plain(y, bias, bn, act, train, update_stats=update)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_card_eval_and_no_batchnorm_bit_for_bit(cuda, shape, dtype):
    """Eval mode and the no-BatchNorm forward are the plain version's bits,
    and so is the no-BatchNorm backward's dx."""
    for mode, act in (("eval", "LeakyReLU"), ("eval", "ReLU"),
                      ("none", "LeakyReLU"), ("none", "None")):
        y, bias, bn, g = card_case(shape, mode, dtype, cuda)
        before = block_epilogue.launches
        got = block_epilogue(y, bias, bn, act, False)
        assert block_epilogue.launches == before + (2 if bn else 1)
        assert torch.equal(got, plain(y, bias, bn, act, False)), (mode, act)
        if mode == "none":
            _, (dk, bk), _ = run(function, y, bias, None, g, act, False)
            _, (dp, bp), _ = run(plain, y, bias, None, g, act, False)
            assert torch.equal(dk, dp)
            # T(sum dz), summed in another order
            assert rel_err(bk, bp) <= (2 ** -8 if dtype == torch.bfloat16
                                       else 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_card_train_matches_plain_and_repeats(cuda, shape, dtype):
    """Train mode.  The forward against the plain version: the moments are
    summed in another order, 1e-5 apart, which may flip one rounding of the
    scale or shift (1e-2 of the output's range in bf16, 1e-5 in float32).
    The backward kernels against the plain backward on the kernels' own
    statistics (with the plain ones, a shift of the scale in its last bit
    moves a z that lies within that bit of 0 across LeakyReLU's kink, where
    the derivative jumps a hundredfold): dy to one rounding of its type
    (2^-7 of its range in bf16, 1e-5 in float32), the per-channel
    gradients, sums in another order rounded to the type, to one such
    rounding (2^-7 in bf16, 1e-4 in float32; the bias's, a sum of dx,
    against the sum of |dx|).  Two runs equal bit for bit, in 3 launches
    forward and 4 backward."""
    y, bias, bn, g = card_case(shape, "train", dtype, cuda)
    before = block_epilogue.launches
    got = run(function, y, bias, bn, g, "LeakyReLU", True)
    assert block_epilogue.launches == before + 7
    again = run(function, y, bias, bn, g, "LeakyReLU", True)
    assert torch.equal(got[0], again[0])
    for a, b in zip(got[1] + got[2], again[1] + again[2]):
        assert torch.equal(a, b)
    ref = run(plain, y, bias, bn, g, "LeakyReLU", True)
    bf16 = dtype == torch.bfloat16
    assert rel_err(got[0], ref[0]) <= (1e-2 if bf16 else 1e-5)
    for a, b in zip(got[2], ref[2]):
        assert rel_err(a, b) <= 1e-5
    spec = EPILOGUE._Spec(copy.deepcopy(bn), "LeakyReLU", True, False, None,
                          False)
    with torch.no_grad():
        _, stats = EPILOGUE._forward_cuda(y, bias, bn.weight, bn.bias, spec)
        needs = (True,) * 4
        args = (g, y, bias, bn.weight, stats, spec, needs)
        kern = EPILOGUE._backward_cuda(*args)
        math = EPILOGUE._backward_math(*args)
    assert rel_err(kern[0], math[0]) <= (2 ** -7 if bf16 else 1e-5)
    names = ("dbias", "dweight", "dshift")
    for name, a, b in zip(names, kern[1:], math[1:]):
        scale = math[0].float().abs().sum(dim=VOXELS).max().item() \
            if name == "dbias" else None
        assert rel_err(a, b, scale) <= (2 ** -7 if bf16 else 1e-4), name


@pytest.mark.cuda
def test_card_channel_slice_gradient(cuda):
    """An upstream gradient that is a channel slice of a concatenation's
    (the deconv blocks' outputs) is read in place, with the same bits as
    its contiguous copy."""
    y, bias, bn, g = card_case((1, 9, 10, 11, 16), "train", torch.bfloat16,
                               cuda)
    wide = torch.cat([g, g[..., :8]], dim=-1)
    got = run(function, y, bias, bn, wide[..., :16], "LeakyReLU", True)
    ref = run(function, y, bias, bn, g, "LeakyReLU", True)
    for a, b in zip(got[1], ref[1]):
        assert torch.equal(a, b)


def seg_step(model, x, labels, remat):
    """Gradients and statistics after one bf16 UNet_light training step's
    backward (dice loss on the logits)."""
    from deepatlas_torch.losses import get_loss_function
    model = copy.deepcopy(model)
    for m in model.modules():
        if hasattr(m, "remat"):
            m.remat = remat
    loss_fn = get_loss_function("dice")(n_class=5)
    loss = loss_fn(model(x, train=True).float(), labels)
    loss.backward()
    torch.cuda.synchronize()
    return ([p.grad.clone() for p in model.parameters()],
            [b.clone() for b in model.buffers()])


@pytest.mark.cuda
def test_card_remat_seg_step_and_launches(cuda):
    """One UNet_light seg step on the card: the 17 blocks' epilogues launch
    3 kernels forward and 4 backward each (bias and BatchNorm in train
    mode); with
    remat each recomputes its forward (3 more), and the gradients and
    statistics are the same bit for bit."""
    from deepatlas_torch.models.unet import UNetTemplate
    torch.manual_seed(3)
    model = UNetTemplate(((8, 16), (16, 16, 32), (32, 32, 64), (64, 64, 64)),
                         ((64, 64, 64), (64, 32, 32), (32, 16, 16)),
                         in_channel=1, n_classes=5, bias=True, BN=True,
                         act="LeakyReLU", dtype=torch.bfloat16).to(cuda)
    x = torch.rand(1, 48, 56, 40, 1, device=cuda)
    labels = torch.randint(0, 5, (1, 48, 56, 40), device=cuda)
    blocks = sum(isinstance(m, (layers.ConvBlock, layers.DeconvBlock))
                 for m in model.modules())
    assert blocks == 17
    runs = {}
    for remat in (False, True):
        kernels.reset_launch_counts()
        runs[remat] = seg_step(model, x, labels, remat)
        assert kernels.launch_counts()["block_epilogue"] == \
            17 * (3 + 4 + 3 * remat)
    for a, b in zip(runs[False][0] + runs[False][1],
                    runs[True][0] + runs[True][1]):
        assert torch.equal(a, b)
