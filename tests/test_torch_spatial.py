"""The spatial (depth-sharded) tier over ``torch.distributed``: the halo
exchange and its adjoint, the sharded forward, eval and seg / reg / joint
steps, DP x SP on a 2 x 2 mesh, the depth-sharded losses, and
``infer_seg_torch.py --spatial-shards 2``.

Each case runs the port's tier in 2 (or 4) gloo processes on the CPU,
spawned once per module with a ``file://`` address under ``tmp_path`` (no
ports), and holds it against the port's own single-process step on the
whole volume and against the JAX tier (``deepatlas_tpu.parallel.spatial``)
on a mesh of the same size, as ``tests/test_spatial.py`` holds the JAX
tier.  Weights come from the JAX init through ``models/convert.py``;
inputs from a numpy seed.  Both sides step with SGD (lr 1e-2), so the
parameters after a step compare the gradients linearly (Adam's update
is about lr in size however small the gradient).

Tolerances (float32), those of ``tests/test_spatial.py``: forward 2e-5
absolute; losses 1e-5 relative (2e-5 for the joint steps); parameters
after a step 2e-5 absolute (3e-5 for the joint steps and DP x SP); BatchNorm
statistics 2e-5; the warped image 1e-4; the serving CLI's labels equal.
"""
import io
import multiprocessing as mp
import os
import traceback
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

N_CLASS = 3
SGD_LR = 1e-2


# ------------------------------------------------------------ rank pool

def _serve(rank, world, init, q_in, q_out):
    torch.set_num_threads(1)
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    while True:
        task = q_in.get()
        if task is None:
            break
        fn, args = task
        try:
            q_out.put((rank, True, fn(*args)))
        except Exception:
            q_out.put((rank, False, traceback.format_exc()))
    dist.destroy_process_group()


class Ranks:
    """``world`` spawned processes in one gloo process group; ``run(fn,
    *args)`` calls ``fn(*args)`` on every rank at once and returns the
    ranks' results in rank order."""

    def __init__(self, world, tmpdir):
        ctx = mp.get_context("spawn")
        init = "file://" + os.path.join(str(tmpdir), f"pg{world}")
        self.world = world
        self.q_in = [ctx.Queue() for _ in range(world)]
        self.q_out = ctx.Queue()
        self.procs = [ctx.Process(target=_serve, daemon=True,
                                  args=(r, world, init, self.q_in[r],
                                        self.q_out))
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def run(self, fn, *args):
        for q in self.q_in:
            q.put((fn, args))
        out = [None] * self.world
        for _ in range(self.world):
            rank, ok, res = self.q_out.get(timeout=300)
            if not ok:
                raise RuntimeError(f"rank {rank}:\n{res}")
            out[rank] = res
        return out

    def close(self):
        for q in self.q_in:
            q.put(None)
        for p in self.procs:
            p.join(30)
            if p.is_alive():
                p.kill()


@pytest.fixture(scope="module")
def ranks2(tmp_path_factory):
    r = Ranks(2, tmp_path_factory.mktemp("pg2"))
    yield r
    r.close()


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    r = Ranks(4, tmp_path_factory.mktemp("pg4"))
    yield r
    r.close()


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------- models, weights and inputs

SEG_PLAN = dict(encoders=((2, 4), (4, 4)), decoders=((4, 4, 4),),
                in_channel=1, n_classes=N_CLASS, act="LeakyReLU")
VM_PLAN = dict(enc_filters=(4, 8, 8, 8, 8), dec_filters=(8, 8, 8, 4, 4),
               flow_scale=0.1)


def seg_model(state, BN=True):
    from deepatlas_torch.models import UNetTemplate
    m = UNetTemplate(bias=not BN, BN=BN, **SEG_PLAN)
    m.load_state_dict(state)
    return m


def vm_model(state):
    from deepatlas_torch.models import VoxelMorphCVPR2018
    m = VoxelMorphCVPR2018(max_disp=8, **VM_PLAN)
    m.load_state_dict(state)
    return m


def sgd_state(model):
    from deepatlas_torch.train import TrainState
    return TrainState(model, torch.optim.SGD(model.parameters(), lr=SGD_LR))


def jax_seg(x, BN=True):
    """The JAX model, its variables (JAX init) and the port's state dict
    converted from them."""
    import jax

    from deepatlas_tpu.models import UNetTemplate as JaxUNet
    from deepatlas_torch.models import UNetTemplate, unet_from_flax
    model = JaxUNet(bias=not BN, BN=BN, **SEG_PLAN)
    sv = model.init(jax.random.PRNGKey(0), x, train=False)
    sd = unet_from_flax(sv, UNetTemplate(bias=not BN, BN=BN, **SEG_PLAN))
    return model, sv, {k: torch.as_tensor(np.array(v)) for k, v in sd.items()}


def jax_vm(mov, fix):
    import jax

    from deepatlas_tpu.models import VoxelMorphCVPR2018 as JaxVM
    from deepatlas_torch.models import VoxelMorphCVPR2018, voxelmorph_from_flax
    model = JaxVM(**VM_PLAN)
    sv = model.init(jax.random.PRNGKey(0), mov, fix)
    sd = voxelmorph_from_flax(sv, VoxelMorphCVPR2018(**VM_PLAN))
    return model, sv, {k: torch.as_tensor(np.array(v)) for k, v in sd.items()}


def jax_state(model, sv):
    """A JAX train state on copies of ``sv`` (the JAX steps donate their
    state's buffers)."""
    import jax
    import jax.numpy as jnp
    import optax

    from deepatlas_tpu.train.steps import TrainState
    sv = jax.tree_util.tree_map(jnp.copy, sv)
    return TrainState.create(apply_fn=model.apply, params=sv["params"],
                             batch_stats=sv.get("batch_stats", {}),
                             tx=optax.sgd(SGD_LR))


def jax_mesh(*shape):
    import jax
    from jax.sharding import Mesh
    n = int(np.prod(shape))
    names = ("space",) if len(shape) == 1 else ("data", "space")
    return Mesh(np.asarray(jax.devices()[:n]).reshape(shape), names)


def seg_inputs(b=2, seed=7):
    rng = np.random.RandomState(seed)
    return (rng.rand(b, 16, 8, 8, 1).astype(np.float32),
            rng.randint(0, N_CLASS, (b, 16, 8, 8)).astype(np.int64))


def vm_inputs(b=1, seed=7):
    rng = np.random.RandomState(seed)
    return (rng.rand(b, 64, 16, 16, 1).astype(np.float32),
            rng.rand(b, 64, 16, 16, 1).astype(np.float32))


def cat_depth(parts):
    return np.concatenate([np.asarray(p) for p in parts], axis=1)


def close(a, b, atol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                               atol=atol)


def close_state(ranks_sd, ref_sd, atol, keys=None):
    """Every rank's state dict against the reference, entry by entry."""
    for sd in ranks_sd:
        for k in keys or ref_sd:
            close(sd[k], ref_sd[k], atol)


def jax_params_sd(jax_model_state, torch_model, convert):
    sv = {"params": jax_model_state.params}
    if jax_model_state.batch_stats:
        sv["batch_stats"] = jax_model_state.batch_stats
    return {k: np.array(v) for k, v in convert(sv, torch_model).items()}


# ------------------------------------------------------ worker functions

def _mesh(data=1, space=None):
    import torch.distributed as dist

    from deepatlas_torch.parallel import make_mesh
    world = dist.get_world_size()
    return make_mesh(data=data, space=space or world // data)


def w_halo(x, halo, weight):
    from deepatlas_torch.ops.halo import halo_exchange_d
    from deepatlas_torch.parallel import shard_volume_batch
    mesh = _mesh()
    xs = torch.from_numpy(shard_volume_batch(x, mesh)).requires_grad_(True)
    out = halo_exchange_d(xs, mesh.axis("space"), halo)
    w = torch.from_numpy(shard_volume_batch(weight, mesh))
    (out * w).sum().backward()
    return out.detach().numpy(), xs.grad.numpy()


def w_seg_forward(sd, BN, x):
    from deepatlas_torch.parallel import (make_spatial_seg_forward,
                                          shard_volume_batch)
    mesh = _mesh()
    m = seg_model(sd, BN)
    out = make_spatial_seg_forward(m, mesh)(
        sgd_state(m), torch.from_numpy(shard_volume_batch(x, mesh)))
    return out.numpy()


def w_seg_step(sd, BN, x, labels, data):
    from deepatlas_torch.losses import get_loss_function
    from deepatlas_torch.parallel import (make_spatial_seg_step,
                                          shard_volume_batch)
    mesh = _mesh(data)
    data_axis = "data" if data > 1 else None
    m = seg_model(sd, BN)
    step = make_spatial_seg_step(
        m, get_loss_function("dice"), N_CLASS, mesh, data_axis=data_axis,
        criterion_kwargs=dict(weight_type="Uniform", softmax=True))
    xs, ls = shard_volume_batch((x, labels), mesh, data_axis=data_axis)
    _, loss, logits = step(sgd_state(m), torch.from_numpy(xs),
                           torch.from_numpy(ls))
    return float(loss), {k: v.numpy() for k, v in m.state_dict().items()}


def w_seg_step_remat(sd, x, labels):
    """One spatial seg step without and with remat on the same weights:
    loss, gradients and state dict of each."""
    from deepatlas_torch.losses import get_loss_function
    from deepatlas_torch.parallel import (make_spatial_seg_step,
                                          shard_volume_batch)
    mesh = _mesh()
    xs, ls = shard_volume_batch((x, labels), mesh)
    out = []
    for remat in (False, True):
        m = seg_model(sd)
        for blk in m.modules():
            if hasattr(blk, "remat"):
                blk.remat = remat
        step = make_spatial_seg_step(
            m, get_loss_function("dice"), N_CLASS, mesh,
            criterion_kwargs=dict(weight_type="Uniform", softmax=True))
        _, loss, _ = step(sgd_state(m), torch.from_numpy(xs),
                          torch.from_numpy(ls))
        out.append((loss.numpy(),
                    {k: p.grad.numpy() for k, p in m.named_parameters()},
                    {k: v.numpy() for k, v in m.state_dict().items()}))
    return out


def w_seg_eval(sd, x, labels):
    from deepatlas_torch.parallel import (make_spatial_seg_eval_step,
                                          shard_volume_batch)
    mesh = _mesh()
    m = seg_model(sd)
    xs, ls = shard_volume_batch((x, labels), mesh)
    dice, logits = make_spatial_seg_eval_step(m, N_CLASS, mesh)(
        sgd_state(m), torch.from_numpy(xs), torch.from_numpy(ls))
    return dice.numpy(), logits.numpy()


def w_losses(a, b, field):
    from deepatlas_torch.losses import get_loss_function
    from deepatlas_torch.parallel import shard_volume_batch
    mesh = _mesh()
    ax = mesh.axis("space")
    a, b, field = (torch.from_numpy(t) for t in
                   shard_volume_batch((a, b, field), mesh))
    lncc = get_loss_function("lncc")(filter_size=9, axis_name=ax)
    out = {"lncc": float(lncc(a, b))}
    for norm in ("L2", "L1"):
        be = get_loss_function("bendingEnergy")(norm=norm, axis_name=ax)
        out["bending_" + norm] = float(be(field))
    return out


def w_vm_forward(sd, mov, fix):
    from deepatlas_torch.models import use_spatial_axis
    from deepatlas_torch.parallel import shard_volume_batch
    mesh = _mesh()
    m = vm_model(sd)
    ms, fs = shard_volume_batch((mov, fix), mesh)
    with torch.no_grad(), use_spatial_axis(m, mesh.axis("space")):
        out = m(torch.from_numpy(ms), torch.from_numpy(fs))
    return [t.numpy() for t in out]


def w_reg_step(sd, mov, fix, data):
    from deepatlas_torch.losses import get_loss_function
    from deepatlas_torch.parallel import (make_spatial_reg_step,
                                          shard_volume_batch)
    mesh = _mesh(data)
    data_axis = "data" if data > 1 else None
    m = vm_model(sd)
    step = make_spatial_reg_step(
        m, get_loss_function("lncc"), get_loss_function("bendingEnergy"),
        0.5, mesh, data_axis=data_axis, sim_kwargs=dict(filter_size=9))
    ms, fs = shard_volume_batch((mov, fix), mesh, data_axis=data_axis)
    _, metrics = step(sgd_state(m), torch.from_numpy(ms),
                      torch.from_numpy(fs))
    return ({k: float(v) for k, v in metrics.items()},
            {k: v.numpy() for k, v in m.state_dict().items()})


def w_joint(seg_sd, reg_sd, arrays, flags):
    from deepatlas_torch.losses import get_loss_function as g
    from deepatlas_torch.parallel import (make_spatial_joint_steps,
                                          shard_volume_batch)
    mesh = _mesh()
    seg, reg = seg_model(seg_sd), vm_model(reg_sd)
    reg_step, seg_step = make_spatial_joint_steps(
        seg, reg, g("lncc"), g("bendingEnergy"), g("dice"), N_CLASS,
        reg_weight=0.5, anatomy_weight=0.3, supervised_weight=1.0,
        mesh=mesh, sim_kwargs=dict(filter_size=9),
        supervised_kwargs=dict(weight_type="Uniform", softmax=True,
                               eps=1e-6))
    shards = [torch.from_numpy(a) for a in shard_volume_batch(arrays, mesh)]
    flags = [torch.tensor(f) for f in flags]
    _, rm = reg_step(sgd_state(reg), sgd_state(seg_model(seg_sd)), *shards,
                     *flags)
    _, sm = seg_step(sgd_state(seg), sgd_state(vm_model(reg_sd)), *shards,
                     *flags)
    return ({k: float(v) for k, v in rm.items()},
            {k: float(v) for k, v in sm.items()},
            {k: v.numpy() for k, v in reg.state_dict().items()},
            {k: v.numpy() for k, v in seg.state_dict().items()})


def w_cli(main_module, argv):
    import importlib
    buf = io.StringIO()
    with redirect_stdout(buf):
        importlib.import_module(main_module).main(argv)
    return buf.getvalue()


# ----------------------------------------------------------------- tests

def test_halo_exchange_matches_pad_and_its_adjoint(ranks2):
    """Each rank's block is the zero-padded global slice; the backward adds
    the halo planes' gradients into the neighbours' boundary planes; the
    JAX exchange gives the same blocks."""
    from functools import partial

    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from deepatlas_tpu.ops.halo import halo_exchange_d as jax_halo
    try:
        from jax import shard_map
    except ImportError:
        from jax.experimental.shard_map import shard_map
    rng = np.random.RandomState(7)
    x = rng.rand(1, 8, 3, 4, 2).astype(np.float32)
    halo = 2
    weight = rng.rand(1, 16, 3, 4, 2).astype(np.float32)  # 8 planes a rank
    res = ranks2.run(w_halo, x, halo, weight)
    xp = np.pad(x, [(0, 0), (halo, halo), (0, 0), (0, 0), (0, 0)])
    blocks = [xp[:, 4 * i:4 * i + 8] for i in range(2)]
    for (out, _), ref in zip(res, blocks):
        np.testing.assert_array_equal(out, ref)
    # adjoint: d/dx of sum_r <block_r, weight_r>
    grad = np.zeros_like(xp)
    for i in range(2):
        grad[:, 4 * i:4 * i + 8] += weight[:, 8 * i:8 * i + 8]
    np.testing.assert_allclose(cat_depth([g for _, g in res]),
                               grad[:, halo:-halo], rtol=1e-6)
    fn = shard_map(partial(jax_halo, axis_name="space", halo=halo),
                   mesh=jax_mesh(2), in_specs=P(None, "space"),
                   out_specs=P(None, "space"), check_vma=False)
    np.testing.assert_array_equal(np.asarray(fn(jnp.asarray(x))),
                                  cat_depth([o for o, _ in res]))


@pytest.mark.parametrize("BN", [False, True])
def test_spatial_forward_matches_single_and_jax(ranks2, BN):
    import jax.numpy as jnp

    from deepatlas_tpu.parallel.spatial import (
        make_spatial_seg_forward as jax_forward, shard_volume_batch as jsv)
    x, _ = seg_inputs(1)
    model, sv, sd = jax_seg(jnp.asarray(x), BN)
    got = cat_depth(ranks2.run(w_seg_forward, sd, BN, x))
    with torch.no_grad():
        ref = seg_model(sd, BN)(torch.from_numpy(x), train=False)
    close(got, ref, 2e-5)
    mesh = jax_mesh(2)
    jref = jax_forward(model, mesh)(jax_state(model, sv),
                                    jsv(jnp.asarray(x), mesh))
    close(got, jref, 2e-5)


def test_spatial_seg_step_matches_single_and_jax(ranks2):
    import jax.numpy as jnp

    from deepatlas_tpu.losses import get_loss_function as jax_loss
    from deepatlas_tpu.parallel.spatial import (
        make_spatial_seg_step as jax_step, shard_volume_batch as jsv)
    from deepatlas_torch.losses import get_loss_function
    from deepatlas_torch.models import UNetTemplate, unet_from_flax
    from deepatlas_torch.train import make_seg_train_step
    x, labels = seg_inputs(2)
    model, sv, sd = jax_seg(jnp.asarray(x[:1]))
    res = ranks2.run(w_seg_step, sd, True, x, labels, 1)
    kw = dict(weight_type="Uniform", softmax=True)
    m = seg_model(sd)
    _, loss, _ = make_seg_train_step(get_loss_function("dice")(
        n_class=N_CLASS, **kw))(sgd_state(m), torch.from_numpy(x),
                                torch.from_numpy(labels))
    ref = {k: v.numpy() for k, v in m.state_dict().items()}
    for r_loss, _ in res:
        np.testing.assert_allclose(r_loss, float(loss), rtol=1e-5)
    close_state([sd_ for _, sd_ in res], ref, 2e-5)

    mesh = jax_mesh(2)
    step = jax_step(model, jax_loss("dice"), n_class=N_CLASS, mesh=mesh,
                    criterion_kwargs=kw)
    js, jloss, _ = step(jax_state(model, sv),
                        *jsv((jnp.asarray(x), jnp.asarray(labels)), mesh))
    np.testing.assert_allclose(res[0][0], float(jloss), rtol=1e-5)
    close_state([sd_ for _, sd_ in res],
                jax_params_sd(js, UNetTemplate(bias=False, BN=True,
                                               **SEG_PLAN), unet_from_flax),
                2e-5)


def test_spatial_seg_step_with_remat_equals_without(ranks2):
    """remat recomputes each block in the backward on the shard it ran on
    (its halo exchange and its BatchNorm's all-reduce again, in the same
    block order on every rank): loss, gradients, statistics and parameters
    equal the step without remat bit for bit on both ranks."""
    import jax.numpy as jnp
    x, labels = seg_inputs(2)
    _, _, sd = jax_seg(jnp.asarray(x[:1]))
    for plain, remat in ranks2.run(w_seg_step_remat, sd, x, labels):
        np.testing.assert_array_equal(plain[0], remat[0])
        for a, b in zip(plain[1:], remat[1:]):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_spatial_seg_eval_matches_single_and_jax(ranks2):
    import jax.numpy as jnp

    from deepatlas_tpu.parallel.spatial import (
        make_spatial_seg_eval_step as jax_eval, shard_volume_batch as jsv)
    from deepatlas_torch.train import make_seg_eval_step
    x, labels = seg_inputs(2)
    model, sv, sd = jax_seg(jnp.asarray(x[:1]))
    res = ranks2.run(w_seg_eval, sd, x, labels)
    dice_ref, logits_ref = make_seg_eval_step(N_CLASS)(
        sgd_state(seg_model(sd)), torch.from_numpy(x),
        torch.from_numpy(labels))
    for dice, _ in res:
        close(dice, dice_ref, 1e-5)
    close(cat_depth([lg for _, lg in res]), logits_ref, 2e-5)
    mesh = jax_mesh(2)
    jdice, _ = jax_eval(model, N_CLASS, mesh)(
        jax_state(model, sv),
        *jsv((jnp.asarray(x), jnp.asarray(labels.astype(np.int32))), mesh))
    close(res[0][0], jdice, 1e-5)


def test_spatial_with_data_parallel(ranks4):
    """DP x SP on a 2 x 2 (data, space) mesh equals the single-process step
    on the whole batch, and the JAX tier on a (2, 2) mesh."""
    import jax.numpy as jnp

    from deepatlas_tpu.losses import get_loss_function as jax_loss
    from deepatlas_tpu.parallel.spatial import (
        make_spatial_seg_step as jax_step, shard_volume_batch as jsv)
    from deepatlas_torch.losses import get_loss_function
    from deepatlas_torch.models import UNetTemplate, unet_from_flax
    from deepatlas_torch.train import make_seg_train_step
    x, labels = seg_inputs(2)
    model, sv, sd = jax_seg(jnp.asarray(x[:1]), BN=False)
    res = ranks4.run(w_seg_step, sd, False, x, labels, 2)
    kw = dict(weight_type="Uniform", softmax=True)
    m = seg_model(sd, BN=False)
    _, loss, _ = make_seg_train_step(get_loss_function("dice")(
        n_class=N_CLASS, **kw))(sgd_state(m), torch.from_numpy(x),
                                torch.from_numpy(labels))
    for r_loss, _ in res:
        np.testing.assert_allclose(r_loss, float(loss), rtol=1e-5)
    close_state([s for _, s in res],
                {k: v.numpy() for k, v in m.state_dict().items()}, 3e-5)
    mesh = jax_mesh(2, 2)
    step = jax_step(model, jax_loss("dice"), n_class=N_CLASS, mesh=mesh,
                    data_axis="data", criterion_kwargs=kw)
    js, jloss, _ = step(jax_state(model, sv),
                        *jsv((jnp.asarray(x), jnp.asarray(labels)), mesh,
                             data_axis="data"))
    np.testing.assert_allclose(res[0][0], float(jloss), rtol=1e-5)
    close_state([s for _, s in res],
                jax_params_sd(js, UNetTemplate(bias=True, BN=False,
                                               **SEG_PLAN), unet_from_flax),
                3e-5)


def test_spatial_losses_match_global(ranks2):
    import jax.numpy as jnp

    from deepatlas_tpu.losses import get_loss_function as jax_loss
    from deepatlas_torch.losses import get_loss_function
    rng = np.random.RandomState(3)
    a = rng.rand(1, 24, 12, 12, 1).astype(np.float32)
    b = rng.rand(1, 24, 12, 12, 1).astype(np.float32)
    field = (rng.randn(1, 24, 12, 12, 3) * 0.1).astype(np.float32)
    res = ranks2.run(w_losses, a, b, field)
    ref = {"lncc": float(get_loss_function("lncc")(filter_size=9)(
        torch.from_numpy(a), torch.from_numpy(b)))}
    jref = {"lncc": float(jax_loss("lncc")(filter_size=9)(
        jnp.asarray(a), jnp.asarray(b)))}
    for norm in ("L2", "L1"):
        ref["bending_" + norm] = float(get_loss_function("bendingEnergy")(
            norm=norm)(torch.from_numpy(field)))
        jref["bending_" + norm] = float(jax_loss("bendingEnergy")(
            norm=norm)(jnp.asarray(field)))
    for r in res:
        for k in ref:
            np.testing.assert_allclose(r[k], ref[k], rtol=1e-5, err_msg=k)
            np.testing.assert_allclose(r[k], jref[k], rtol=1e-5, err_msg=k)


def test_spatial_voxelmorph_forward_matches_single(ranks2):
    """Stride-2 convs at depth padding 0, shard-local upsamples, the global
    identity and the halo'd warp on kernel E."""
    import jax.numpy as jnp
    mov, fix = vm_inputs()
    _, _, sd = jax_vm(jnp.asarray(mov), jnp.asarray(fix))
    res = ranks2.run(w_vm_forward, sd, mov, fix)
    with torch.no_grad():
        ref = vm_model(sd)(torch.from_numpy(mov), torch.from_numpy(fix))
    for i, atol in enumerate((2e-5, 1e-4, 2e-5)):
        close(cat_depth([r[i] for r in res]), ref[i], atol)


@pytest.mark.parametrize("data", [1, 2])
def test_spatial_reg_step_matches_single_and_jax(ranks2, ranks4, data):
    import jax.numpy as jnp

    from deepatlas_tpu.losses import _bending_factory, _lncc_factory
    from deepatlas_tpu.parallel.spatial import (
        make_spatial_reg_step as jax_step, shard_volume_batch as jsv)
    from deepatlas_torch.losses import get_loss_function
    from deepatlas_torch.models import VoxelMorphCVPR2018, voxelmorph_from_flax
    from deepatlas_torch.train import make_reg_train_step
    mov, fix = vm_inputs(data)
    model, sv, sd = jax_vm(jnp.asarray(mov[:1]), jnp.asarray(fix[:1]))
    res = (ranks2 if data == 1 else ranks4).run(w_reg_step, sd, mov, fix,
                                                data)
    m = vm_model(sd)
    _, metrics = make_reg_train_step(
        get_loss_function("lncc")(filter_size=9),
        get_loss_function("bendingEnergy")(), 0.5)(
            sgd_state(m), torch.from_numpy(mov), torch.from_numpy(fix))
    atol = 2e-5 if data == 1 else 3e-5
    for r, _ in res:
        for k in ("loss", "sim", "reg"):
            np.testing.assert_allclose(r[k], float(metrics[k]), rtol=1e-5,
                                       err_msg=k)
    close_state([s for _, s in res],
                {k: v.numpy() for k, v in m.state_dict().items()}, atol)
    mesh = jax_mesh(2) if data == 1 else jax_mesh(2, 2)
    step = jax_step(model, _lncc_factory, _bending_factory, reg_weight=0.5,
                    mesh=mesh, data_axis="data" if data > 1 else None,
                    sim_kwargs=dict(filter_size=9))
    js, jm = step(jax_state(model, sv),
                  *jsv((jnp.asarray(mov), jnp.asarray(fix)), mesh,
                       data_axis="data" if data > 1 else None))
    for k in ("loss", "sim", "reg"):
        np.testing.assert_allclose(res[0][0][k], float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    close_state([s for _, s in res],
                jax_params_sd(js, VoxelMorphCVPR2018(**VM_PLAN),
                              voxelmorph_from_flax), atol)


def test_spatial_joint_steps_match_single(ranks2):
    """The depth-sharded joint reg and seg steps (soft path) against the
    single-process steps (dense anatomy, one graph) on a mixed-label pair,
    the frozen net's substitution and the soft anatomy both engaged, and
    against the JAX tier (whose XLA warp is unclamped: the field here is
    far below 8 voxels, flow_scale 0.1)."""
    import jax.numpy as jnp

    from deepatlas_torch.losses import get_loss_function as g
    from deepatlas_torch.train import make_joint_reg_step, make_joint_seg_step
    mov, fix = vm_inputs()
    rng = np.random.RandomState(5)
    mseg = rng.randint(0, N_CLASS, (1, 64, 16, 16)).astype(np.int64)
    fseg = rng.randint(0, N_CLASS, (1, 64, 16, 16)).astype(np.int64)
    flags = (np.array([True]), np.array([False]))
    _, _, seg_sd = jax_seg(jnp.asarray(mov))
    _, _, reg_sd = jax_vm(jnp.asarray(mov), jnp.asarray(fix))
    res = ranks2.run(w_joint, seg_sd, reg_sd, (mov, fix, mseg, fseg), flags)

    sup = g("dice")(n_class=N_CLASS, weight_type="Uniform", softmax=True,
                    eps=1e-6)
    ref_reg = make_joint_reg_step(g("lncc")(filter_size=9),
                                  g("bendingEnergy")(), 0.5, 0.3, N_CLASS,
                                  max_disp=8)
    ref_seg = make_joint_seg_step(sup, 0.3, 1.0, N_CLASS, two_pass=False)
    args = [torch.from_numpy(a) for a in (mov, fix, mseg, fseg)] + \
        [torch.tensor(f) for f in flags]
    reg, seg = vm_model(reg_sd), seg_model(seg_sd)
    _, rm = ref_reg(sgd_state(reg), sgd_state(seg_model(seg_sd)), *args)
    _, sm = ref_seg(sgd_state(seg), sgd_state(vm_model(reg_sd)), *args)
    for r_rm, r_sm, r_reg, r_seg in res:
        for k in ("loss", "sim", "reg", "anatomy", "disp_overflow"):
            np.testing.assert_allclose(r_rm[k], float(rm[k]), rtol=2e-5,
                                       atol=1e-7, err_msg=k)
        for k in ("loss", "anatomy", "supervised"):
            np.testing.assert_allclose(r_sm[k], float(sm[k]), rtol=2e-5,
                                       err_msg=k)
        close_state([r_reg], {k: v.numpy()
                              for k, v in reg.state_dict().items()}, 3e-5)
        close_state([r_seg], {k: v.numpy()
                              for k, v in seg.state_dict().items()}, 3e-5)

    # the JAX tier on a 2-device mesh, from the same JAX init
    from deepatlas_tpu.losses import (_bending_factory, _dice_factory,
                                      _lncc_factory)
    from deepatlas_tpu.parallel.spatial import (
        make_spatial_joint_steps as jax_steps, shard_volume_batch as jsv)
    from deepatlas_torch.models import (UNetTemplate, VoxelMorphCVPR2018,
                                        unet_from_flax, voxelmorph_from_flax)
    seg_jm, seg_sv, _ = jax_seg(jnp.asarray(mov))
    reg_jm, reg_sv, _ = jax_vm(jnp.asarray(mov), jnp.asarray(fix))
    mesh = jax_mesh(2)
    jreg, jseg = jax_steps(
        seg_jm, reg_jm, _lncc_factory, _bending_factory, _dice_factory,
        n_class=N_CLASS, reg_weight=0.5, anatomy_weight=0.3,
        supervised_weight=1.0, mesh=mesh, sim_kwargs=dict(filter_size=9),
        supervised_kwargs=dict(weight_type="Uniform", softmax=True,
                               eps=1e-6))
    shards = jsv(tuple(jnp.asarray(a) for a in
                       (mov, fix, mseg.astype(np.int32),
                        fseg.astype(np.int32))), mesh)
    jflags = tuple(jnp.asarray(f) for f in flags)
    rs, jrm = jreg(jax_state(reg_jm, reg_sv), jax_state(seg_jm, seg_sv),
                   *shards, *jflags)
    ss, jsm = jseg(jax_state(seg_jm, seg_sv), jax_state(reg_jm, reg_sv),
                   *shards, *jflags)
    r_rm, r_sm, r_reg, r_seg = res[0]
    for k in ("loss", "sim", "reg", "anatomy"):
        np.testing.assert_allclose(r_rm[k], float(jrm[k]), rtol=2e-5,
                                   err_msg=k)
    for k in ("loss", "anatomy", "supervised"):
        np.testing.assert_allclose(r_sm[k], float(jsm[k]), rtol=2e-5,
                                   err_msg=k)
    close_state([r_reg], jax_params_sd(rs, VoxelMorphCVPR2018(**VM_PLAN),
                                       voxelmorph_from_flax), 3e-5)
    close_state([r_seg], jax_params_sd(ss, UNetTemplate(
        bias=False, BN=True, **SEG_PLAN), unet_from_flax), 3e-5)


def test_infer_seg_torch_spatial_shards_serves_whole_volumes(ranks2,
                                                             tmp_path):
    """``infer_seg_torch.py --spatial-shards 2`` in 2 processes: the
    labels rank 0 writes are the argmax of the single-process forward of
    the whole volume, and its dice lines match them."""
    from deepatlas_torch.data import read_nifti, write_nifti
    from deepatlas_torch.models import UNetLight
    from deepatlas_torch.train import save_checkpoint
    rng = np.random.RandomState(11)
    root = tmp_path / "oai"
    root.mkdir()
    names = ["k0_RIGHT", "k1_RIGHT"]
    vols = []
    for name in names:
        img = rng.rand(32, 16, 24).astype(np.float32)
        write_nifti(root / f"{name}_image.nii.gz", img)
        write_nifti(root / f"{name}_masks.nii.gz",
                    rng.randint(0, 3, img.shape).astype(np.uint8))
        vols.append(img)
    (root / "test.txt").write_text("\n".join(names) + "\n")
    torch.manual_seed(0)
    model = UNetLight(in_channel=1, n_classes=3, bias=True, BN=True)
    save_checkpoint({"epoch": 1, "best_score": 0.0,
                     "model": model.state_dict()}, True,
                    str(tmp_path / "ckpt"))
    argv = ["--ckpt", str(tmp_path / "ckpt" / "model_best"),
            "--data-root", str(root), "--list-file", str(root / "test.txt"),
            "--data", "OAI", "--n-classes", "3", "--no-bf16",
            "--device", "cpu", "--spatial-shards", "2",
            "--out-dir", str(tmp_path / "preds")]
    outs = ranks2.run(w_cli, "infer_seg_torch", argv)
    assert outs[1] == ""
    lines = outs[0].strip().splitlines()
    assert len(lines) == 3
    model.eval()
    for name, vol in zip(names, vols):
        img = read_nifti(str(tmp_path / "preds" / f"{name}_pred.nii.gz"))
        with torch.no_grad():
            ref = model(torch.from_numpy(vol)[None, ..., None]).argmax(-1)
        np.testing.assert_array_equal(np.asarray(img.data),
                                      ref[0].numpy().astype(np.uint8))
