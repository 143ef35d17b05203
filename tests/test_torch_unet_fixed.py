"""deepatlas_torch's fixed ``UNet`` against the JAX package's ``UNet``.

The JAX model's variables (randomized with numpy: weights, biases,
BatchNorm affine and running statistics) are converted with
``unet_from_flax``; both nets run the same 16^3 input in float32 through
the forward in eval and train mode, with and without BatchNorm, then one
segmentation step's loss and parameter gradients.  The port reaches kernels
A, B, C and D's plain versions on the CPU through the wrappers the card
uses.

Tolerances (float32; both sides compute the same formulas in another
summation order): logits 1e-4 of their largest entry; moved BatchNorm
statistics 1e-4 relative; the loss 1e-5.  Each parameter gradient is held
against the JAX step's gradients computed in float64, to 1e-4 of its
tensor's largest entry or, where the step itself is ill-conditioned, to
three times the most that a relative change of 1e-7 in the input image
moves the port's own gradient of that tensor (``conditioning``).  Without
BatchNorm that bound is never needed (the port lies within 4e-6 of the JAX
float32 gradients).  With BatchNorm over the deepest level's 16 voxels a
channel's batch variance amplifies rounding: a 1e-7 change of the input
moves the port's gradients by up to 1e-2 of a tensor's largest entry, and
the JAX package's own float32 gradients lie up to 5e-2 from its float64
ones (the port's up to 1e-2), so float64 is the reference.  A conv bias in
front of a BatchNorm has a gradient that is rounding noise by construction
(the batch mean removes the bias): held to 1e-6 of the net's largest
gradient entry.
"""
import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepatlas_tpu.losses import get_loss_function as jax_get_loss
from deepatlas_tpu.models import UNet as JaxUNet
from deepatlas_tpu.models import get_available_networks as jax_networks
from deepatlas_torch.losses import get_loss_function
from deepatlas_torch.models import (UNet, UNetTemplate, get_network,
                                    unet_from_flax)

VOL = (2, 16, 16, 16, 1)
NC = 4
LOSS = {"n_class": NC, "weight_type": "Uniform", "no_bg": False,
        "softmax": True, "eps": 1e-6}
REL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several pytest-xdist workers at once; torch's
    default of one intra-op thread per core would oversubscribe the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def randomize(variables, rng):
    """Every leaf of a flax UNet tree drawn from ``rng`` at a scale that
    keeps activations O(1), with positive running variances."""
    def draw(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "kernel":
            a = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "var":
            a = rng.uniform(0.5, 1.5, shape)
        elif name == "scale":
            a = 1 + 0.2 * rng.randn(*shape)
        else:                                   # bias, BN bias, mean
            a = 0.2 * rng.randn(*shape)
        return jnp.asarray(a.astype(np.float32))
    return jax.tree_util.tree_map_with_path(draw, variables)


def build(bn):
    rng = np.random.RandomState(231 + bn)
    x = rng.rand(*VOL).astype(np.float32)
    y = rng.randint(0, NC, VOL[:4]).astype(np.int32)
    jax_model = JaxUNet(in_channel=1, n_classes=NC, bias=True, BN=bn)
    variables = jax.jit(jax_model.init, static_argnames="train")(
        jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    variables = randomize(dict(variables), rng)
    model = UNet(in_channel=1, n_classes=NC, bias=True, BN=bn)
    model.load_state_dict(unet_from_flax(variables, model))
    return x, y, jax_model, variables, model


@pytest.fixture(scope="module", params=[True, False], ids=["BN", "noBN"])
def nets(request):
    return build(request.param)


def assert_logits(got, ref):
    assert got.shape == VOL[:4] + (NC,)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=REL * np.abs(ref).max())


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_forward_matches_jax(nets, train):
    x, _, jax_model, variables, model = nets
    twin = copy.deepcopy(model)
    ref, mutated = jax.jit(
        lambda v, a: jax_model.apply(v, a, train=train,
                                     mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        out = twin(torch.from_numpy(x), train=train).numpy()
    assert_logits(out, np.asarray(ref))
    if "batch_stats" not in variables:
        return
    # train mode moves every BatchNorm's running statistics as flax does
    want = unet_from_flax({"params": variables["params"],
                           "batch_stats": mutated["batch_stats"]}, twin)
    moved = 0
    for k, v in twin.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=REL,
                                   atol=1e-6, err_msg=k)
        moved += not torch.equal(v, model.state_dict()[k])
    assert moved == (2 * 17 if train else 0)


def jax_step_gradients(jax_model, variables, x, y, dtype):
    """The JAX seg step's loss and parameter gradients in ``dtype``."""
    jax_loss = jax_get_loss("dice")(**LOSS)
    variables = jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a), dtype), variables)

    def loss_of(params):
        logits, _ = jax_model.apply(dict(variables, params=params),
                                    jnp.asarray(x, dtype), train=True,
                                    mutable=["batch_stats"])
        return jax_loss(logits.astype(dtype), jnp.asarray(y))

    loss, grads = jax.jit(jax.value_and_grad(loss_of))(variables["params"])
    return float(loss), jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64), grads)


def port_step_gradients(model, x, y):
    twin = copy.deepcopy(model)
    loss = get_loss_function("dice")(**LOSS)(
        twin(torch.from_numpy(x), train=True).float(), torch.from_numpy(y))
    loss.backward()
    return loss.item(), {n: p.grad.double()
                         for n, p in twin.named_parameters()}


def test_seg_step_gradients_match_jax(nets):
    x, y, jax_model, variables, model = nets
    ref_loss32, _ = jax_step_gradients(jax_model, variables, x, y,
                                       jnp.float32)
    with jax.enable_x64(True):
        ref_loss, ref_grads = jax_step_gradients(jax_model, variables, x, y,
                                                 jnp.float64)
    ref = {k: v.double() for k, v in unet_from_flax(
        {"params": ref_grads}, model, params_only=True).items()}
    loss, got = port_step_gradients(model, x, y)
    _, nudged = port_step_gradients(model, (x * (1 + 1e-7)).astype(
        np.float32), y)
    np.testing.assert_allclose(loss, ref_loss32, rtol=0, atol=1e-5)
    np.testing.assert_allclose(loss, ref_loss, rtol=0, atol=1e-5)
    biggest = max(r.abs().max().item() for r in ref.values())
    bn = "batch_stats" in variables
    for name, g in got.items():
        r = ref[name]
        scale = r.abs().max().item()
        if bn and name.endswith(".bias") and ".bn." not in name \
                and not name.startswith("head."):
            limit = 1e-6 * biggest
        else:
            conditioning = (nudged[name] - g).abs().max().item()
            limit = max(REL * scale, 3 * conditioning)
            assert bn or limit == REL * scale, name
        err = (g - r).abs().max().item()
        assert err <= limit, (name, err, limit, scale)


def test_registry_remat_tree_and_keywords():
    assert get_network("UNet") is UNet
    assert set(jax_networks()) == {"UNet", "UNet_light", "voxel_morph_cvpr"}
    model = get_network("UNet")(in_channel=1, n_classes=NC, bias=True,
                                BN=True, dtype=torch.bfloat16)
    assert isinstance(model, UNetTemplate) and model.dtype == torch.bfloat16
    convs = [b.weight.shape for lvl in (*model.enc, *model.dec) for b in lvl]
    assert [tuple(s[-2:]) for s in convs] == [
        (1, 32), (32, 64), (64, 64), (64, 128), (128, 128), (128, 256),
        (256, 256), (256, 512), (768, 256), (256, 256), (384, 128),
        (128, 128), (192, 64), (64, 64)]
    assert [tuple(u.weight.shape) for u in model.ups] == [
        (2, 2, 2, 512, 512), (2, 2, 2, 256, 256), (2, 2, 2, 128, 128)]
    assert tuple(model.head.weight.shape) == (64, NC)
    # spatial_axis (the depth-sharded tier's mesh axis) reaches every
    # block and BatchNorm, as the JAX UNet passes it to its blocks
    from deepatlas_torch.parallel import make_mesh
    axis = make_mesh().axis("space")
    sharded = UNet(spatial_axis=axis)
    assert sharded.spatial_axis is axis
    assert all(m.spatial_axis is axis for m in sharded.modules()
               if hasattr(m, "spatial_axis"))
    # a remat-built JAX UNet names its blocks Checkpoint*: its tree (the
    # standard tree relabelled) converts to the same weights and logits
    x, _, _, variables, model = build(True)
    remat_model = JaxUNet(in_channel=1, n_classes=NC, bias=True, BN=True,
                          remat=True)
    shapes = jax.eval_shape(lambda: remat_model.init(
        jax.random.PRNGKey(0), jnp.asarray(x), train=False))

    def relabel(tree):
        return {("Checkpoint" + k if "Block" in k else k): v
                for k, v in tree.items()}

    remat_vars = {c: relabel(variables[c]) for c in variables}
    assert set(remat_vars["params"]) == set(shapes["params"])
    twin = UNet(in_channel=1, n_classes=NC, bias=True, BN=True)
    twin.load_state_dict(unet_from_flax(remat_vars, twin))
    for (k, a), b in zip(model.state_dict().items(),
                         twin.state_dict().values()):
        assert torch.equal(a, b), k
    ref = remat_model.apply(remat_vars, jnp.asarray(x), train=False)
    with torch.no_grad():
        assert_logits(twin.eval()(torch.from_numpy(x)).numpy(),
                      np.asarray(ref))


def test_infer_seg_torch_serves_the_unet(tmp_path, capsys):
    """``--model UNet`` end to end: a JAX UNet checkpoint ->
    tools/flax_ckpt_to_torch.py -> infer_seg_torch.py on the CPU labels
    every voxel as the JAX package's serving path (``make_tile_predictor``
    and ``sliding_window_predict`` of ``deepatlas_tpu.train``, which
    ``infer_seg.py`` runs) labels it on the original checkpoint, up to
    near-tie flips, with the same Dice.  (``infer_seg.py --model UNet``
    itself raises: it passes ``packed=`` to every network, and the JAX
    ``UNet`` takes no such keyword.)"""
    import json

    import infer_seg_torch
    from deepatlas_tpu.metrics.confusion import (confusion_matrix,
                                                 dice_from_confusion)
    from deepatlas_tpu.train import load_checkpoint as jax_load
    from deepatlas_tpu.train import make_tile_predictor
    from deepatlas_tpu.train import save_checkpoint as jax_save
    from deepatlas_tpu.train.inference import sliding_window_predict
    from deepatlas_torch.data import read_nifti, write_nifti
    from tools import flax_ckpt_to_torch

    rng = np.random.RandomState(233)
    names = ["k0_RIGHT", "k1_LEFT"]
    volumes = {}
    for name in names:
        seg = np.zeros((24, 24, 24), np.uint8)
        seg[4:12, 6:14, 5:15] = 1
        seg[12:20, 10:18, 8:16] = 2
        img = (seg / 3.0 + 0.1 * rng.rand(*seg.shape)).astype(np.float32)
        write_nifti(tmp_path / f"{name}_image.nii.gz", img)
        write_nifti(tmp_path / f"{name}_masks.nii.gz", seg)
        volumes[name] = img, seg
    (tmp_path / "test.txt").write_text("".join(f"{n}\n" for n in names))
    model = JaxUNet(in_channel=1, n_classes=3, bias=True, BN=True)
    variables = randomize(dict(jax.jit(model.init, static_argnames="train")(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 16, 1)),
        train=False)), rng)
    jax_save({"epoch": 2, "best_score": 0.25, "params": variables["params"],
              "batch_stats": variables["batch_stats"], "opt_state": None},
             True, str(tmp_path / "jax_ckpt"))
    restored = jax_load(str(tmp_path / "jax_ckpt" / "model_best"))
    predict = make_tile_predictor(
        model.apply, {"params": restored["params"],
                      "batch_stats": restored["batch_stats"]}, 2)

    flax_ckpt_to_torch.main(["--ckpt",
                             str(tmp_path / "jax_ckpt" / "model_best"),
                             "--out", str(tmp_path / "torch_ckpt"),
                             "--model", "UNet", "--n-classes", "3"])
    capsys.readouterr()
    infer_seg_torch.main([
        "--ckpt", str(tmp_path / "torch_ckpt" / "model_best"),
        "--data-root", str(tmp_path), "--list-file",
        str(tmp_path / "test.txt"), "--data", "OAI", "--model", "UNet",
        "--n-classes", "3", "--tile-size", "16", "16", "16", "--overlap",
        "4", "4", "4", "--tile-batch", "2", "--no-bf16", "--device", "cpu",
        "--out-dir", str(tmp_path / "preds")])
    out = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
           if ln.startswith("{")]
    assert [ln.get("name") for ln in out] == names + [None]
    for line in out[:2]:
        img, seg = volumes[line["name"]]
        ref = sliding_window_predict(predict, {"image": img[..., None]},
                                     (16, 16, 16), (4, 4, 4))
        got = read_nifti(line["saved"]).data
        assert got.shape == ref.shape
        assert (got == ref).mean() >= 0.999
        dice = dice_from_confusion(confusion_matrix(
            jnp.asarray(ref[None], jnp.int32),
            jnp.asarray(seg[None], jnp.int32), 3), 1e-11)[1:]
        np.testing.assert_allclose(line["dice"], np.asarray(dice),
                                   atol=2e-3)
