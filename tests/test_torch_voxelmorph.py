"""VoxelMorph of deepatlas_torch against the JAX package, on the CPU: the
strided ConvBlock (forward, ``dx``, ``dW``, ``db`` against flax at odd
sizes), and the whole network (``disp``, ``warped``, ``deform``) in float32
and bfloat16 from converted weights of both JAX parameter trees, at a size
whose halvings are odd (21 -> 11 -> 6 -> 3 -> 2).

The JAX side is the standard (XLA) trunk.  The packed trunk computes the
same function from the same numbers under other module names (the JAX
package's own ``tests/test_packed_voxelmorph.py`` holds that, in interpret
mode, marked slow), so its tree is built here by that file's relabelling
and must convert to the very same state dict.

Tolerances.  float32: 11 convs in another order of summation: 1e-5 of the
displacement's largest entry; the warp of a [0, 1] image by fields that
differ by that little: 1e-4.  bfloat16: both packages round every layer's
output to bf16; one rounding flip is 2^-8 relative and 11 layers compound
them: 4e-2 of the largest displacement (measured 1.5e-2), and the warped
image, sampled at coordinates that differ by that, 5e-2.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepatlas_tpu.models import VoxelMorphCVPR2018 as JaxVoxelMorph
from deepatlas_tpu.models.layers import ConvBlock as JaxConvBlock
from deepatlas_torch.models import (ConvBlock, VoxelMorphCVPR2018,
                                    get_network, voxelmorph_from_flax)

VOL = (1, 21, 18, 20, 1)
ENC, DEC = (4, 8, 8, 8, 8), (8, 8, 8, 4, 4)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several pytest-xdist workers at once; torch's
    default of one intra-op thread per core would oversubscribe the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def randomize(variables, rng, head_scale=1.0):
    """Random kernels (fan-in scale) and biases; the flow head scaled so
    that the field is a few voxels."""
    def draw(path, leaf):
        shape = leaf.shape
        if path[-1].key == "kernel":
            a = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
            if shape[-1] == 3:
                a = a * head_scale
        else:
            a = 0.1 * rng.randn(*shape)
        return jnp.asarray(a.astype(np.float32))
    return jax.tree_util.tree_map_with_path(draw, variables)


def packed_tree(std):
    """The standard tree relabelled as the packed trunk stores it."""
    p = std["params"]
    mapping = {"ConvBlock_0": "PackedConvBlock_0",
               "ConvBlock_1": "PackedConvBlock_1",
               "ConvBlock_2": "ConvBlock_0", "ConvBlock_3": "ConvBlock_1",
               "ConvBlock_4": "ConvBlock_2", "ConvBlock_5": "ConvBlock_3",
               "ConvBlock_6": "ConvBlock_4", "ConvBlock_7": "ConvBlock_5",
               "ConvBlock_8": "PackedConvBlock_2",
               "ConvBlock_9": "PackedConvBlock_3"}
    out = {}
    for src, dst in mapping.items():
        out[dst] = dict(p[src]["Conv_0"]) if dst.startswith("Packed") \
            else p[src]
    out["PackedConvBlock_4"] = dict(p["Conv_0"])
    return {"params": out}


# ------------------------------------------------------ strided ConvBlock

@pytest.mark.parametrize("shape,cin,cout,stride", [
    ((1, 7, 9, 5), 3, 4, 2), ((2, 6, 5, 8), 2, 5, 2), ((1, 5, 4, 6), 3, 2, 1)],
    ids=["odd", "mixed_batch2", "stride1"])
def test_strided_conv_block_matches_flax(rng, shape, cin, cout, stride):
    """Forward, ``dx``, ``dW`` and ``db``; output size ``ceil(n / 2)``."""
    x = rng.randn(*shape, cin).astype(np.float32)
    jblock = JaxConvBlock(cout, 3, stride, 1, use_bias=True, batchnorm=False,
                          act="ReLU")
    variables = randomize(dict(jblock.init(jax.random.PRNGKey(0),
                                           jnp.asarray(x), False)), rng)
    ref = jblock.apply(variables, jnp.asarray(x), False)
    ct = rng.randn(*ref.shape).astype(np.float32)

    block = ConvBlock(cin, cout, stride=stride)
    conv = numpy_tree(variables)["params"]["Conv_0"]
    block.load_state_dict({"weight": torch.from_numpy(conv["kernel"].copy()),
                           "bias": torch.from_numpy(conv["bias"].copy())})
    xt = torch.from_numpy(x).requires_grad_(True)
    got = block(xt)
    assert tuple(got.shape) == ref.shape == (
        shape[0], *[-(-n // stride) for n in shape[1:]], cout)
    assert got.is_contiguous()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=1e-5)
    (got * torch.from_numpy(ct)).sum().backward()

    def loss(v, a):
        return jnp.sum(jblock.apply(v, a, False) * ct)

    gvars, gx = jax.grad(loss, argnums=(0, 1))(variables, jnp.asarray(x))
    gconv = numpy_tree(gvars)["params"]["Conv_0"]
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=1e-5)
    np.testing.assert_allclose(block.weight.grad.numpy(), gconv["kernel"],
                               atol=1e-4)
    np.testing.assert_allclose(block.bias.grad.numpy(), gconv["bias"],
                               atol=1e-4)
    with pytest.raises(ValueError, match="stride must be 1 or 2"):
        ConvBlock(cin, cout, stride=3)


def test_strided_wrappers_and_their_operand_checks(rng):
    """``stride=2`` of the k3 wrappers equals the stride-1 conv at the even
    voxels, and its weight gradient the stride-1 one on the upstream
    gradient put at the even voxels of a zero tensor (exactly: the plain
    versions compute them that way)."""
    from deepatlas_torch.kernels import (conv3d_k3, conv3d_k3_plain,
                                         conv3d_k3_wgrad,
                                         conv3d_k3_wgrad_plain)
    x = torch.from_numpy(rng.randn(2, 5, 6, 7, 3).astype(np.float32))
    w = torch.from_numpy(rng.randn(3, 3, 3, 3, 4).astype(np.float32))
    b = torch.from_numpy(rng.randn(4).astype(np.float32))
    y = conv3d_k3(x, w, b, stride=2)
    assert y.shape == (2, 3, 3, 4, 4)
    assert torch.equal(y, conv3d_k3(x, w, b)[:, ::2, ::2, ::2])
    assert torch.equal(y, conv3d_k3_plain(x, w, b, stride=2))
    g = torch.from_numpy(rng.randn(2, 3, 3, 4, 4).astype(np.float32))
    full = torch.zeros(2, 5, 6, 7, 4)
    full[:, ::2, ::2, ::2] = g
    dw = conv3d_k3_wgrad(x, g, stride=2)
    assert torch.equal(dw, conv3d_k3_wgrad(x, full))
    assert torch.equal(dw, conv3d_k3_wgrad_plain(x, g, stride=2))
    with pytest.raises(ValueError, match="stride must be 1 or 2"):
        conv3d_k3(x, w, stride=3)
    with pytest.raises(ValueError, match="stride must be 1 or 2"):
        conv3d_k3_wgrad(x, g, stride=0)
    with pytest.raises(ValueError, match="share their voxels"):
        conv3d_k3_wgrad(x, full, stride=2)
    with pytest.raises(ValueError, match="share their voxels"):
        conv3d_k3_wgrad(x, g)


# ------------------------------------------------------------ the network

@pytest.fixture(scope="module")
def nets():
    rng = np.random.RandomState(11)
    src = rng.rand(*VOL).astype(np.float32)
    tgt = rng.rand(*VOL).astype(np.float32)
    jmodel = JaxVoxelMorph(enc_filters=ENC, dec_filters=DEC)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(src),
                                     jnp.asarray(tgt))
    variables = randomize(dict(variables), rng, head_scale=0.3)
    return src, tgt, variables


@pytest.mark.parametrize("tree", ["standard", "packed"])
@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bfloat16"])
def test_forward_matches_jax_from_either_tree(nets, tree, bf16):
    src, tgt, variables = nets
    jmodel = JaxVoxelMorph(enc_filters=ENC, dec_filters=DEC,
                           dtype=jnp.bfloat16 if bf16 else None)
    jdisp, jwarped, jdeform = jmodel.apply(variables, jnp.asarray(src),
                                           jnp.asarray(tgt))
    assert jdisp.dtype == jnp.float32
    model = VoxelMorphCVPR2018(enc_filters=ENC, dec_filters=DEC,
                               dtype=torch.bfloat16 if bf16 else None,
                               max_disp=None)
    given = numpy_tree(variables)
    model.load_state_dict(voxelmorph_from_flax(
        given if tree == "standard" else packed_tree(given), model))
    with torch.no_grad():
        disp, warped, deform = model(torch.from_numpy(src),
                                     torch.from_numpy(tgt))
    assert disp.dtype == warped.dtype == deform.dtype == torch.float32
    assert disp.shape == VOL[:4] + (3,) and warped.shape == VOL
    scale = np.abs(np.asarray(jdisp)).max()
    # the field is a few voxels: 2 / (n - 1) normalized units per voxel
    assert scale * (VOL[3] - 1) / 2 > 1.0
    tol, wtol = (4e-2, 5e-2) if bf16 else (1e-5, 1e-4)
    assert np.abs(disp.numpy() - np.asarray(jdisp)).max() <= tol * scale
    assert np.abs(deform.numpy() - np.asarray(jdeform)).max() <= tol * scale
    assert np.abs(warped.numpy() - np.asarray(jwarped)).max() <= wtol


def test_clamp_flow_scale_and_train_flag(nets):
    """``max_disp`` against the JAX model on its bounded kernel path (the
    Pallas warp in interpret mode), ``flow_scale``, and ``train`` (there is
    no BatchNorm: it changes nothing)."""
    src, tgt, variables = nets
    jmodel = JaxVoxelMorph(enc_filters=ENC, dec_filters=DEC,
                           use_pallas_warp=True, max_disp=1, flow_scale=3.0,
                           interpret=True)
    jdisp, jwarped, jdeform = jmodel.apply(variables, jnp.asarray(src),
                                           jnp.asarray(tgt))
    model = get_network("voxel_morph_cvpr")(enc_filters=ENC, dec_filters=DEC,
                                            max_disp=1, flow_scale=3.0)
    model.load_state_dict(voxelmorph_from_flax(numpy_tree(variables), model))
    with torch.no_grad():
        disp, warped, deform = model(torch.from_numpy(src),
                                     torch.from_numpy(tgt), train=True)
        again = model(torch.from_numpy(src), torch.from_numpy(tgt))
    scale = np.abs(np.asarray(jdisp)).max()
    assert np.abs(disp.numpy() - np.asarray(jdisp)).max() <= 1e-5 * scale
    assert np.abs(warped.numpy() - np.asarray(jwarped)).max() <= 1e-4
    assert torch.equal(again[1], warped)
    model.max_disp = None
    with torch.no_grad():
        free = model(torch.from_numpy(src), torch.from_numpy(tgt))[1]
    assert (free - warped).abs().max().item() > 0.05    # the clamp acted
    # the returned deformation is the unclamped one, as in the JAX package
    assert np.abs(deform.numpy() - np.asarray(jdeform)).max() <= 1e-5 * scale
    assert (deform - disp - model(torch.from_numpy(src), torch.from_numpy(
        tgt))[2].detach() + disp).abs().max().item() < 1e-6


def test_converter_refuses_trees_that_do_not_fit(nets):
    _, _, variables = nets
    given = numpy_tree(variables)
    model = VoxelMorphCVPR2018(enc_filters=ENC, dec_filters=DEC)
    missing = {"params": {k: v for k, v in given["params"].items()
                          if k != "ConvBlock_3"}}
    with pytest.raises(ValueError, match="neither the standard nor"):
        voxelmorph_from_flax(missing, model)
    wide = VoxelMorphCVPR2018(enc_filters=(4, 8, 8, 8, 16), dec_filters=DEC)
    with pytest.raises(ValueError, match="shape"):
        voxelmorph_from_flax(given, wide)
    with pytest.raises(ValueError, match="five encoder"):
        VoxelMorphCVPR2018(enc_filters=(4, 8), dec_filters=DEC)
    with pytest.raises(TypeError):
        get_network("voxel_morph_cvpr")(packed=True)
    n_flax = sum(np.size(a) for a in jax.tree_util.tree_leaves(
        given["params"]))
    assert sum(p.numel() for p in model.parameters()) == n_flax
    full = VoxelMorphCVPR2018()
    assert full.head.weight.shape == (3, 3, 3, 24, 3)
    assert full.dec[3].weight.shape == (3, 3, 3, 64, 8)


# ------------------------------------------- the decoder's 2x upsample

@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bfloat16"])
def test_nearest_up2x_is_the_identity_bank_deconv(rng, bf16):
    """``nearest_up2x`` (the k2 s2 transposed-conv wrapper on the identity
    bank, what the JAX packed trunk's ``packed_nearest_up2`` runs) against
    both packages' ``nearest_resize`` to twice the size: the forward bit for
    bit (a copy), the input gradient (a sum of 8 values, in another order)
    to 1e-6 in float32 and one bf16 rounding (2^-8 relative) in bfloat16;
    torch's own bfloat16 backward of ``nearest_resize`` rounds after each of
    its three axes, so it is held to three roundings."""
    from deepatlas_tpu.ops.resize import nearest_resize as jax_resize
    from deepatlas_torch.kernels import deconv2x, nearest_up2x
    from deepatlas_torch.ops import nearest_resize

    dtype = torch.bfloat16 if bf16 else torch.float32
    x = rng.randn(2, 3, 5, 4, 6).astype(np.float32)
    ct = rng.randn(2, 6, 10, 8, 6).astype(np.float32)
    out_shape = (6, 10, 8)
    xt = torch.from_numpy(x).to(dtype).requires_grad_(True)
    got = nearest_up2x(xt)
    assert got.dtype == dtype and got.shape == ct.shape
    xr = xt.detach().clone().requires_grad_(True)
    ref = nearest_resize(xr, out_shape)
    assert torch.equal(got, ref)
    jref = jax_resize(jnp.asarray(xt.detach().float().numpy()), out_shape)
    assert np.array_equal(got.detach().float().numpy(), np.asarray(jref))
    (got.float() * torch.from_numpy(ct)).sum().backward()
    (ref.float() * torch.from_numpy(ct)).sum().backward()
    jgrad = jax.grad(lambda v: jnp.sum(jax_resize(v, out_shape) * ct))(
        jnp.asarray(x))
    tol = 2.0 ** -8 if bf16 else 1e-6
    scale = np.abs(np.asarray(jgrad)).max()
    assert np.abs(xt.grad.float().numpy() - np.asarray(jgrad)).max() \
        <= tol * scale
    assert (xt.grad.float() - xr.grad.float()).abs().max().item() \
        <= (3 * tol if bf16 else tol) * scale
    # the same function as deconv2x on an explicit identity bank
    bank = torch.eye(6).expand(2, 2, 2, 6, 6).contiguous()
    assert torch.equal(got, deconv2x(xt.detach(), bank))


def test_even_volume_upsamples_through_the_deconv_kernel(rng):
    """At a size whose first halving is exact the decoder's last upsample
    is ``nearest_up2x`` (once per forward) and the network still matches
    the JAX one: 1e-5 of the largest displacement, and parameter gradients
    to 1e-4 of each tensor's largest entry against the same net with the
    upsample on ``nearest_resize`` (float32, another order of 8 additions).
    At an odd size it is ``nearest_resize`` and the wrapper is not called."""
    from unittest import mock

    from deepatlas_torch.models import voxelmorph
    from deepatlas_torch.ops import nearest_resize

    vol = (1, 8, 12, 16, 1)
    src = rng.rand(*vol).astype(np.float32)
    tgt = rng.rand(*vol).astype(np.float32)
    jmodel = JaxVoxelMorph(enc_filters=ENC, dec_filters=DEC)
    variables = randomize(dict(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.asarray(src), jnp.asarray(tgt))), rng,
        head_scale=0.3)
    jdisp, jwarped, _ = jmodel.apply(variables, jnp.asarray(src),
                                     jnp.asarray(tgt))
    model = VoxelMorphCVPR2018(enc_filters=ENC, dec_filters=DEC,
                               max_disp=None)
    model.load_state_dict(voxelmorph_from_flax(numpy_tree(variables), model))

    def grads(**patch):
        model.zero_grad(set_to_none=True)
        with mock.patch.multiple(voxelmorph, **patch):
            disp, warped, _ = model(torch.from_numpy(src),
                                    torch.from_numpy(tgt), train=True)
        ((warped - torch.from_numpy(tgt)) ** 2).mean().backward()
        return disp.detach(), {n: p.grad.clone()
                               for n, p in model.named_parameters()}

    spy = mock.Mock(side_effect=voxelmorph.nearest_up2x)
    disp, got = grads(nearest_up2x=spy)
    assert spy.call_count == 1
    scale = np.abs(np.asarray(jdisp)).max()
    assert np.abs(disp.numpy() - np.asarray(jdisp)).max() <= 1e-5 * scale
    disp_r, ref = grads(nearest_up2x=lambda h: nearest_resize(
        h, [2 * n for n in h.shape[1:4]]))
    assert torch.equal(disp, disp_r)
    for name, r in ref.items():
        assert (got[name] - r).abs().max().item() \
            <= 1e-4 * r.abs().max().item(), name

    odd = torch.from_numpy(rng.rand(*VOL).astype(np.float32))
    spy.reset_mock()
    with mock.patch.object(voxelmorph, "nearest_up2x", spy), torch.no_grad():
        model(odd, odd)
    assert spy.call_count == 0
