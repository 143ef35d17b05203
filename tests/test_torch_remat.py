"""Rematerialization in deepatlas_torch, on the CPU: per-block ``remat`` on
the U-Nets and VoxelMorph (the joint seg step's ``checkpoint_apply`` is in
``tests/test_torch_remat_joint.py``).

Against the JAX package: ``UNet_light``, the fixed ``UNet`` and VoxelMorph
built with ``remat=True`` on both sides, the port's weights converted from
the JAX model's remat-built tree (``Checkpoint*`` block names): train-mode
output, the moved BatchNorm statistics, one step's loss and parameter
gradients.  Against the port itself: a remat step equals the plain step
bit for bit (loss, gradients, statistics moved once, parameters after
Adam), its recompute adds exactly one forward of every conv and deconv
block, and eval, ``torch.no_grad()`` and serving run each block once.

Tolerances, those of the existing parity tests of these nets.  U-Nets
(``tests/test_torch_unet_fixed.py``): logits 1e-4 of their largest entry,
statistics 1e-4 relative, the loss 1e-5; gradients against the JAX step's
float64 gradients, to 1e-4 of a tensor's largest entry (UNet_light: 2e-3,
the limit of ``tests/test_torch_train_step.py``) or three times what a
1e-7 relative change of the input moves the port's own gradient (BatchNorm
over the deepest level's few voxels conditions them), a conv bias in front
of a BatchNorm to 1e-6 of the largest gradient entry.  The fixed UNet runs
at three draws: that of ``tests/test_torch_unet_fixed.py`` (seed 232) and
two (seeds 2 and 4) where the float32 step lies further from the float64
one than the input change shows; there a gradient may also lie three times
as far from the float64 gradient as the JAX package's own float32 step
does (``gradient_limits``).  ``python tests/test_torch_remat.py UNet 1 2
3`` prints, per draw, the parameter that comes nearest each rule.
VoxelMorph (``tests/test_torch_reg_step.py``): the displacement 1e-5 of its
largest entry, the loss 1e-5, gradients 2e-3 of a tensor's largest entry
plus 1e-7.
"""
import contextlib
import copy
import functools
import os
import threading
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepatlas_tpu.losses import get_loss_function as jax_get_loss
from deepatlas_tpu.models import VoxelMorphCVPR2018 as JaxVoxelMorph
from deepatlas_tpu.models import get_network as jax_get_network
from deepatlas_tpu.train import save_checkpoint as jax_save
from deepatlas_torch import kernels
from deepatlas_torch.kernels import conv3d, deconv3d
from deepatlas_torch.losses import get_loss_function
from deepatlas_torch.models import (VoxelMorphCVPR2018, get_network, layers,
                                    unet_from_flax, voxelmorph_from_flax)
from deepatlas_torch.train import (TrainState, initialize_from,
                                   make_optimizer, make_reg_train_step,
                                   make_seg_train_step, make_tile_predictor)
from test_torch_joint_steps import numpy_tree
from test_torch_unet_fixed import randomize as randomize_unet
from test_torch_voxelmorph import packed_tree
from test_torch_voxelmorph import randomize as randomize_vm

VOL = (2, 16, 16, 16, 1)
NC = 4
LOSS = {"n_class": NC, "weight_type": "Uniform", "no_bg": False,
        "softmax": True, "eps": 1e-6}
REL = 1e-4
GRAD_REL = {"UNet_light": 2e-3, "UNet": 1e-4}
ENC, DEC = (4, 8, 8, 8, 8), (8, 8, 8, 4, 4)
UNETS = ("UNet_light", "UNet")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several pytest-xdist workers at once; torch's
    default of one intra-op thread per core would oversubscribe the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def forwards():
    """Counts the forward calls of the k3 conv, the 1x1x1 conv (its input
    gradient too) and the transposed conv: what the wrappers launch on the
    card, their plain versions here."""
    counts = {"conv3d_k3": 0, "conv3d_point": 0, "deconv2x": 0}

    def counted(name, fn):
        def call(*args, **kw):
            counts[name] += 1
            return fn(*args, **kw)
        return call

    with mock.patch.object(conv3d, "_k3_op",
                           counted("conv3d_k3", conv3d._k3_op)), \
            mock.patch.object(conv3d, "_point_op",
                              counted("conv3d_point", conv3d._point_op)), \
            mock.patch.object(deconv3d, "_deconv_op",
                              counted("deconv2x", deconv3d._deconv_op)):
        yield counts


def blocks(model):
    """(conv blocks, deconv blocks) of ``model`` that recompute."""
    convs = sum(isinstance(m, layers.ConvBlock) and m.remat
                for m in model.modules())
    deconvs = sum(isinstance(m, layers.DeconvBlock) and m.remat
                  for m in model.modules())
    return convs, deconvs


# ----------------------------------------------- the nets against JAX

def jax_unet(name, remat):
    return jax_get_network(name)(in_channel=1, n_classes=NC, bias=True,
                                 BN=True, remat=remat)


def unet_pair(name, seed=232):
    """The JAX net built with remat, its tree (the draw of
    ``tests/test_torch_unet_fixed.py`` from ``seed`` under the remat-built
    names), the port's remat net on the converted weights, and an input
    and labels."""
    rng = np.random.RandomState(seed)
    x = rng.rand(*VOL).astype(np.float32)
    y = rng.randint(0, NC, VOL[:4]).astype(np.int32)
    init = functools.partial(jax.jit(jax_unet(name, False).init,
                                     static_argnames="train"),
                             jax.random.PRNGKey(0), jnp.asarray(x),
                             train=False)
    variables = {c: {("Checkpoint" + k if "Block" in k else k): v
                     for k, v in tree.items()}
                 for c, tree in randomize_unet(dict(init()), rng).items()}
    jmodel = jax_unet(name, True)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.asarray(x), train=False))
    assert set(variables["params"]) == set(shapes["params"])
    model = get_network(name)(in_channel=1, n_classes=NC, bias=True, BN=True,
                              remat=True)
    model.load_state_dict(unet_from_flax(variables, model))
    return jmodel, variables, model, x, y


def jax_unet_step(jmodel, variables, x, y, dtype):
    """Loss, parameter gradients and moved statistics of the JAX step in
    ``dtype``."""
    jloss = jax_get_loss("dice")(**LOSS)
    variables = jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a), dtype), variables)

    def loss_of(params):
        logits, moved = jmodel.apply(dict(variables, params=params),
                                     jnp.asarray(x, dtype), train=True,
                                     mutable=["batch_stats"])
        return jloss(logits.astype(dtype), jnp.asarray(y)), (logits, moved)

    (loss, (logits, moved)), grads = jax.jit(
        jax.value_and_grad(loss_of, has_aux=True))(variables["params"])
    as64 = functools.partial(jax.tree_util.tree_map,
                             lambda a: np.asarray(a, np.float64))
    return float(loss), np.asarray(logits), as64(grads), as64(moved)


def port_unet_step(model, x, y):
    twin = copy.deepcopy(model)
    logits = twin(torch.from_numpy(x), train=True)
    loss = get_loss_function("dice")(**LOSS)(logits.float(),
                                             torch.from_numpy(y))
    loss.backward()
    return (loss.item(), logits.detach().numpy(),
            {n: p.grad.double() for n, p in twin.named_parameters()}, twin)


def gradient_limits(name, model, x, y, got, jgrads, jgrads32):
    """Per parameter of the port's gradients ``got``: ``(error, limit,
    terms)``, the error against the JAX float64 gradients ``jgrads`` and
    the limit, the largest of ``terms``: ``GRAD_REL`` of the tensor's
    largest entry, three times what a 1e-7 relative change of the input
    moves the port's gradient (``conditioning``) and three times the JAX
    package's own float32 gradients' (``jgrads32``) error; a conv bias in
    front of a BatchNorm 1e-6 of the largest gradient entry."""
    ref, ref32 = ({k: v.double() for k, v in unet_from_flax(
        {"params": g}, model, params_only=True).items()}
        for g in (jgrads, jgrads32))
    _, _, nudged, _ = port_unet_step(
        model, (x * (1 + 1e-7)).astype(np.float32), y)
    biggest = max(r.abs().max().item() for r in ref.values())
    out = {}
    for pname, g in got.items():
        r = ref[pname]
        err = (g - r).abs().max().item()
        if pname.endswith(".bias") and ".bn." not in pname \
                and not pname.startswith("head."):
            terms = {"bias_before_bn": 1e-6 * biggest}
        else:
            terms = {"rel": GRAD_REL[name] * r.abs().max().item(),
                     "conditioning": 3 * (nudged[pname] - g).abs().max().item(),
                     "reference_float32": 3 * (ref32[pname] - r).abs().max()
                     .item()}
        out[pname] = (err, max(terms.values()), terms)
    return out


def jax_and_port_steps(name, seed):
    """The JAX remat step in float32 and float64 and the port's remat step
    (forward counts too) on ``unet_pair(name, seed)``."""
    jmodel, variables, model, x, y = unet_pair(name, seed)
    loss32, jlogits, jgrads32, moved = jax_unet_step(jmodel, variables, x, y,
                                                     jnp.float32)
    with jax.enable_x64(True):
        loss64, _, jgrads, _ = jax_unet_step(jmodel, variables, x, y,
                                             jnp.float64)
    with forwards() as counts:
        port = port_unet_step(model, x, y)
    return (variables, model, x, y, loss32, jlogits, jgrads32, moved, loss64,
            jgrads, port, counts)


@pytest.mark.parametrize("name,seed", [("UNet_light", 232), ("UNet", 232),
                                       ("UNet", 2), ("UNet", 4)])
def test_remat_unets_match_jax(name, seed):
    (variables, model, x, y, loss32, jlogits, jgrads32, moved, loss64,
     jgrads, (loss, logits, got, twin), counts) = jax_and_port_steps(name,
                                                                     seed)
    convs, deconvs = blocks(model)
    # the recompute runs every conv and deconv block once more
    assert counts == {"conv3d_k3": 2 * convs, "deconv2x": 2 * deconvs,
                      "conv3d_point": 2}
    np.testing.assert_allclose(logits, jlogits, rtol=0,
                               atol=REL * np.abs(jlogits).max())
    np.testing.assert_allclose(loss, loss32, rtol=0, atol=1e-5)
    np.testing.assert_allclose(loss, loss64, rtol=0, atol=1e-5)
    # the statistics moved once, as flax's remat moves them
    want = unet_from_flax({"params": variables["params"],
                           "batch_stats": moved["batch_stats"]}, twin)
    for k, v in twin.named_buffers():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=REL,
                                   atol=1e-6, err_msg=k)
        assert not torch.equal(v, model.state_dict()[k]), k
    limits = gradient_limits(name, model, x, y, got, jgrads, jgrads32)
    for pname, (err, limit, terms) in limits.items():
        assert err <= limit, (pname, err, terms)


def vm_pair(bf16=False):
    rng = np.random.RandomState(17)
    src = rng.rand(1, 16, 16, 16, 1).astype(np.float32)
    tgt = rng.rand(1, 16, 16, 16, 1).astype(np.float32)
    jmodel = JaxVoxelMorph(enc_filters=ENC, dec_filters=DEC, remat=True)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(src),
                                     jnp.asarray(tgt))
    variables = numpy_tree(randomize_vm(dict(variables), rng,
                                        head_scale=0.3))
    model = VoxelMorphCVPR2018(enc_filters=ENC, dec_filters=DEC,
                               max_disp=None, remat=True,
                               dtype=torch.bfloat16 if bf16 else None)
    model.load_state_dict(voxelmorph_from_flax(variables, model))
    return jmodel, variables, model, src, tgt


def test_remat_voxelmorph_matches_jax():
    jmodel, variables, model, src, tgt = vm_pair()
    assert sorted(variables["params"]) == sorted(
        [f"CheckpointConvBlock_{i}" for i in range(10)] + ["Conv_0"])
    jsim = jax_get_loss("lncc")(filter_size=5)
    jreg = jax_get_loss("bendingEnergy")()

    def loss_of(params):
        disp, warped, _ = jmodel.apply({"params": params}, jnp.asarray(src),
                                       jnp.asarray(tgt), train=True)
        return jsim(warped, jnp.asarray(tgt)) + jreg(disp), disp

    (jloss, jdisp), jgrads = jax.jit(jax.value_and_grad(
        loss_of, has_aux=True))(variables["params"])
    ref = voxelmorph_from_flax({"params": numpy_tree(jgrads)}, model)
    with forwards() as counts:
        disp, warped, _ = model(torch.from_numpy(src), torch.from_numpy(tgt),
                                train=True)
        loss = get_loss_function("lncc")(filter_size=5)(
            warped, torch.from_numpy(tgt)) + \
            get_loss_function("bendingEnergy")()(disp)
        loss.backward()
    # ten blocks recompute; the flow head (a plain conv in the JAX trunk)
    # and the decoder's upsample to full resolution do not
    assert blocks(model) == (10, 0)
    assert counts == {"conv3d_k3": 21, "deconv2x": 1, "conv3d_point": 0}
    scale = np.abs(np.asarray(jdisp)).max()
    assert np.abs(disp.detach().numpy() - np.asarray(jdisp)).max() \
        <= 1e-5 * scale
    assert abs(loss.item() - float(jloss)) <= 1e-5
    for name, p in model.named_parameters():
        r = ref[name]
        err = (p.grad - r).abs().max().item()
        assert err <= 2e-3 * r.abs().max().item() + 1e-7, (name, err)


def test_voxelmorph_from_flax_maps_remat_trees(tmp_path):
    """Both JAX VoxelMorph trees built with remat (``CheckpointConvBlock_*``
    blocks; the packed one keeps its ``PackedConvBlock_*``) convert to the
    state dict of the same weights without remat, also through
    ``tools/flax_ckpt_to_torch.py``."""
    from tools import flax_ckpt_to_torch

    _, variables, model, src, tgt = vm_pair()
    plain = {"params": {k.removeprefix("Checkpoint"): v
                        for k, v in variables["params"].items()}}
    want = voxelmorph_from_flax(plain, model)
    got = voxelmorph_from_flax(variables, model)
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    packed = packed_tree(plain)["params"]
    packed = {"params": {("Checkpoint" + k if k.startswith("ConvBlock")
                          else k): v for k, v in packed.items()}}
    # the names of the JAX package's packed remat tree (its packed trunk
    # takes the default widths, its entry a W of 64)
    pair = jnp.zeros((1, 16, 16, 64, 1), jnp.float32)
    shapes = jax.eval_shape(lambda: JaxVoxelMorph(
        remat=True, packed=True, interpret=True).init(
            jax.random.PRNGKey(0), pair, pair))
    assert set(packed["params"]) == set(shapes["params"])
    got = voxelmorph_from_flax(packed, model)
    assert all(torch.equal(got[k], want[k]) for k in want)
    # the converter tool builds the recipe's widths
    full = numpy_tree(JaxVoxelMorph(remat=True).init(
        jax.random.PRNGKey(3), jnp.asarray(src), jnp.asarray(tgt)))
    jax_save({"epoch": 1, "reg_best_score": 0.5, "params": full["params"]},
             True, str(tmp_path / "jax"))
    flax_ckpt_to_torch.main(["--ckpt", str(tmp_path / "jax" / "model_best"),
                             "--out", str(tmp_path / "torch"),
                             "--model", "voxel_morph_cvpr"])
    restored, _, _ = initialize_from(str(tmp_path / "torch"))
    want = voxelmorph_from_flax(
        {"params": {k.removeprefix("Checkpoint"): v
                    for k, v in full["params"].items()}},
        VoxelMorphCVPR2018())
    assert set(restored["model"]) == set(want)
    assert all(torch.equal(restored["model"][k], want[k]) for k in want)


# ------------------------------------------ remat against the plain step

def seg_case(name, bf16):
    torch.manual_seed(5)
    model = get_network(name)(in_channel=1, n_classes=NC, bias=True,
                              BN=True,
                              dtype=torch.bfloat16 if bf16 else None)
    rng = np.random.RandomState(8)
    batch = (torch.from_numpy(rng.rand(1, 16, 16, 16, 1).astype(np.float32)),
             torch.from_numpy(rng.randint(0, NC, (1, 16, 16, 16))))
    step = make_seg_train_step(get_loss_function("dice")(**LOSS))
    return model, batch, step


def reg_case(_, bf16):
    torch.manual_seed(6)
    model = VoxelMorphCVPR2018(enc_filters=ENC, dec_filters=DEC, max_disp=3,
                               dtype=torch.bfloat16 if bf16 else None)
    rng = np.random.RandomState(9)
    batch = tuple(torch.from_numpy(rng.rand(1, 16, 16, 16, 1).astype(
        np.float32)) for _ in range(2))
    step = make_reg_train_step(get_loss_function("lncc")(filter_size=5),
                               get_loss_function("bendingEnergy")(), 1.0,
                               max_disp=3)
    return model, batch, step


def with_remat(model, on=True):
    twin = copy.deepcopy(model)
    for m in twin.modules():
        if isinstance(m, layers._Block) and m is not getattr(
                twin, "head", None):
            m.remat = on
    return twin


def run_steps(model, batch, step, n=2):
    state = TrainState(model, make_optimizer(model, 1e-2))
    out = []
    with forwards() as counts:
        for _ in range(n):
            state, *metrics = step(state, *batch)
            if isinstance(metrics[0], dict):        # the reg step's
                metrics = list(metrics[0].values())
            out.append((dict(enumerate(m.clone() for m in metrics)),
                        {k: p.grad.clone()
                         for k, p in model.named_parameters()},
                        {k: v.clone() for k, v in model.state_dict().items()}))
    return out, dict(counts)


@pytest.mark.parametrize("name,bf16", [
    ("UNet_light", False), ("UNet_light", True), ("UNet", False),
    ("voxel_morph_cvpr", False), ("voxel_morph_cvpr", True)],
    ids=["UNet_light-float32", "UNet_light-bfloat16", "UNet-float32",
         "voxelmorph-float32", "voxelmorph-bfloat16"])
def test_remat_step_equals_plain_step_bit_for_bit(name, bf16):
    """Two train steps (Adam) with remat equal two without, bit for bit:
    metrics, every gradient, the running statistics (moved once a step)
    and the parameters; the steps run one more forward of every block."""
    model, batch, step = (reg_case if name == "voxel_morph_cvpr"
                          else seg_case)(name, bf16)
    start = copy.deepcopy(model.state_dict())
    plain, n_plain = run_steps(with_remat(model, False), batch, step)
    remat_model = with_remat(model)
    convs, deconvs = blocks(remat_model)
    assert convs and (deconvs or name == "voxel_morph_cvpr")
    remat, n_remat = run_steps(remat_model, batch, step)
    assert n_remat == {"conv3d_k3": n_plain["conv3d_k3"] + 2 * convs,
                       "deconv2x": n_plain["deconv2x"] + 2 * deconvs,
                       "conv3d_point": n_plain["conv3d_point"]}
    for i, (a, b) in enumerate(zip(plain, remat)):
        for what, pa, pb in zip(("metrics", "gradients", "state"), a, b):
            for k in pa:
                assert torch.equal(pa[k], pb[k]), (i, what, k)
    moved = [k for k in start if "running" in k
             and not torch.equal(plain[0][2][k], start[k])]
    assert bool(moved) == (name != "voxel_morph_cvpr")


def test_eval_no_grad_and_serving_run_each_block_once():
    """remat recomputes only a differentiated train-mode forward: eval
    mode (with grad), train mode under ``torch.no_grad()`` and the tile
    predictor run UNet_light's 14 convs, 3 deconvs and its head once, and
    the no-grad train forward moves the statistics as without remat."""
    torch.manual_seed(3)
    plain = get_network("UNet_light")(in_channel=1, n_classes=NC, bias=True,
                                      BN=True)
    model = with_remat(plain)
    x = torch.rand(4, 16, 16, 16, 1)
    once = {"conv3d_k3": 14, "deconv2x": 3, "conv3d_point": 1}
    with forwards() as counts:
        out = model(x, train=False)
    assert counts == once and out.requires_grad
    with torch.no_grad(), forwards() as counts:
        a = model(x, train=True)
        b = plain(x, train=True)
    assert counts == {k: 2 * v for k, v in once.items()}
    assert torch.equal(a, b)
    for (k, u), v in zip(model.state_dict().items(),
                         plain.state_dict().values()):
        assert torch.equal(u, v), k
    predict = make_tile_predictor(model, tile_batch=4)
    with forwards() as counts:
        labels = predict(x.numpy())
    assert counts == once and labels.shape == (4, 16, 16, 16)
    vm = with_remat(VoxelMorphCVPR2018(enc_filters=ENC, dec_filters=DEC))
    with forwards() as counts:
        vm(x[:1], x[1:2], train=False)
    assert counts == {"conv3d_k3": 11, "deconv2x": 1, "conv3d_point": 0}


def test_recompute_context_is_per_thread():
    """A BatchNorm forward on another thread moves its statistics while
    this one recomputes, and a remat forward whose backward (with its
    recompute) runs on a thread of its own moves them once and gives the
    plain forward's gradients, bit for bit."""
    bn = layers.BatchNorm(3)
    x = torch.rand(2, 4, 4, 4, 3)
    inside, seen = threading.Event(), {}

    def other():
        inside.wait()
        before = bn.running_mean.clone()
        seen["recomputing"] = layers.recomputing()
        bn(x, train=True)
        seen["moved"] = not torch.equal(before, bn.running_mean)

    worker = threading.Thread(target=other)
    worker.start()
    with layers._recompute():
        assert layers.recomputing()
        inside.set()
        worker.join()
    assert seen == {"recomputing": False, "moved": True}
    assert not layers.recomputing()
    model, (img, seg), _ = seg_case("UNet_light", False)
    out = {}
    for remat in (False, True):
        twin = with_remat(model, remat)
        loss = get_loss_function("dice")(**LOSS)(twin(img, train=True), seg)
        worker = threading.Thread(target=loss.backward)
        with forwards() as counts:
            worker.start()
            worker.join()
        out[remat] = (dict(counts), twin)
    convs, deconvs = blocks(out[True][1])
    # the backward's forwards: the head's input gradient, and with remat
    # every block's recompute
    backward = out[False][0]
    assert backward["conv3d_k3"] == backward["deconv2x"] == 0
    assert out[True][0] == dict(backward, conv3d_k3=convs, deconv2x=deconvs)
    plain, remat = out[False][1], out[True][1]
    for (k, a), b in zip(plain.named_parameters(), remat.parameters()):
        assert torch.equal(a.grad, b.grad), k
    for (k, a), b in zip(plain.state_dict().items(),
                         remat.state_dict().values()):
        assert torch.equal(a, b), k


# ------------------------------------------------- chip_smoke's remat phase

def test_chip_smoke_slab_checks_hold_on_the_plain_versions():
    """``chip_smoke.check_remat_kernels`` at a tiny size on the CPU (the
    wrappers' plain versions; timings and cuDNN stubbed): every slab
    launch covers its planes of the whole-volume launch -- the halo'd
    forward and input-gradient slabs, the half-resolution deconv slabs, the
    pointwise head -- and the weight gradient is the sum of the slabs'; B's
    and C's CUDA-core kernels are timed on the same slabs."""
    import chip_smoke

    keys = ("ms", "plain_ms", "bound_ms", "library_ms", "flops", "bytes",
            "device_ms", "library_device_ms", "cuda_core_ms",
            "cuda_core_device_ms")
    summary = {name: dict({p: dict.fromkeys(keys, 0.0)
                           for p in chip_smoke.PATHS}, max_abs_err=0.0)
               for name in kernels.KERNELS}
    lines = []
    with mock.patch.object(chip_smoke, "cuda_ms", lambda *a, **k: 1.0), \
            mock.patch.object(chip_smoke, "library_call",
                              lambda *a, **k: (lambda: None)), \
            mock.patch.object(chip_smoke, "wgrad_partial_bytes",
                              lambda *a, **k: 0), \
            mock.patch.object(chip_smoke, "log", lines.append), \
            mock.patch.object(torch.cuda, "synchronize", lambda: None), \
            mock.patch.object(torch.cuda, "empty_cache", lambda: None):
        chip_smoke.check_remat_kernels(summary, 0, dhw=(16, 8, 8), slab=4,
                                       device="cpu")
    assert [(ln["kernel"], ln["role"]) for ln in lines] == [
        case[:2] for case in chip_smoke.REMAT_KERNEL_CASES]
    for ln in lines:
        assert ln["ok"] and ln["equal_to_slabs"] and ln["slabs"] == 4, ln
        if ln["kernel"] != "conv3d_k3_wgrad":
            assert ln["max_abs_err_vs_slabs"] == 0.0, ln
    assert summary["conv3d_k3"]["remat"]["bound_ms"] > 0
    # one timing (1.0 here) per slab of each case of B and C, none of A, D
    cases = {name: sum(c[0] == name for c in chip_smoke.REMAT_KERNEL_CASES)
             for name in summary}
    for name, tot in summary.items():
        twin = name in chip_smoke.CUDA_CORE_TWINS
        assert tot["remat"]["cuda_core_ms"] == (4 * cases[name] if twin
                                                else 0.0), name
        assert tot["remat"]["cuda_core_device_ms"] == \
            tot["remat"]["cuda_core_ms"], name


def draw_readings(name, seed):
    """At one draw: the parameter nearest the rule without the reference's
    float32 term and the one nearest the whole rule, each as (name,
    error / limit, error, terms), and the loss against the JAX float64
    step's."""
    (_, model, x, y, _, _, jgrads32, _, loss64, jgrads,
     (loss, _, got, _), _) = jax_and_port_steps(name, seed)
    limits = gradient_limits(name, model, x, y, got, jgrads, jgrads32)

    def nearest(drop):
        return max((err / max(v for k, v in terms.items() if k not in drop),
                    pname, err, terms)
                   for pname, (err, _, terms) in limits.items())
    return {"model": name, "seed": seed, "loss_err": abs(loss - loss64),
            "without_reference_float32": nearest({"reference_float32"}),
            "whole_rule": nearest(set())}


if __name__ == "__main__":
    # python tests/test_torch_remat.py UNet 1 2 3 (from the repository root,
    # JAX_PLATFORMS=cpu): one JSON line of draw_readings per seed
    import json
    import sys

    for s in sys.argv[2:]:
        print(json.dumps(draw_readings(sys.argv[1], int(s))), flush=True)
