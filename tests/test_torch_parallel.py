"""The data-parallel tier over ``torch.distributed``: the seg train, eval
and confusion steps, the registration step, the joint steps, and the seg
experiment under ``data_parallel`` and ``spatial_shards``.

Each case runs the port's tier in 2 gloo processes on the CPU (the rank
pool of ``test_torch_spatial.py``, spawned once for this module with a
``file://`` address, no ports) and holds it against the port's own
single-process step on the merged batch and against the JAX tier
(``deepatlas_tpu.parallel.dp``) on a 2-device mesh, as
``tests/test_parallel.py`` holds the JAX tier.  Weights come from the JAX
init through ``models/convert.py``, inputs from a numpy seed; both sides
step with SGD (lr 1e-2).

Against the single-process step the DP step is exact where the loss is a
mean over the batch and nothing couples the batch's elements: the seg
step with cross-entropy and no BatchNorm, the registration step, the
joint steps with a BatchNorm-free seg net and a cross-entropy supervised
loss.  Each replica normalizes BatchNorm with its own rows and the dice
loss weighs classes over its own rows (as in the JAX tier), so those are
held against the JAX tier instead.

Tolerances (float32): losses and metrics 1e-5 relative (2e-5 for the
joint steps); parameters after a step and BatchNorm statistics 2e-5
absolute (3e-5 for the joint steps); dice 1e-5.
"""
import numpy as np
import pytest
import torch

from test_torch_spatial import (N_CLASS, Ranks, close, close_state,
                                jax_params_sd, jax_seg, jax_state, jax_vm,
                                seg_inputs, seg_model, sgd_state, vm_inputs,
                                vm_model)


@pytest.fixture(scope="module")
def ranks2(tmp_path_factory):
    r = Ranks(2, tmp_path_factory.mktemp("pg2"))
    yield r
    r.close()


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_dp_mesh():
    from deepatlas_tpu.parallel import make_mesh
    return make_mesh(2)


def criterion(name):
    from deepatlas_torch.losses import get_loss_function
    if name == "dice":
        return get_loss_function("dice")(n_class=N_CLASS,
                                         weight_type="Uniform", softmax=True)
    return get_loss_function(name)()


# ------------------------------------------------------ worker functions

def _mesh():
    import torch.distributed as dist

    from deepatlas_torch.parallel import make_mesh
    return make_mesh(data=dist.get_world_size())


def w_dp_seg_step(sd, BN, loss_name, x, labels):
    from deepatlas_torch.parallel import make_dp_seg_train_step, shard_batch
    mesh = _mesh()
    m = seg_model(sd, BN)
    xs, ls = shard_batch((x, labels), mesh)
    _, loss, logits = make_dp_seg_train_step(criterion(loss_name), mesh)(
        sgd_state(m), torch.from_numpy(xs), torch.from_numpy(ls))
    return float(loss), {k: v.numpy() for k, v in m.state_dict().items()}


def w_dp_eval(sd, x, labels):
    from deepatlas_torch.parallel import (make_dp_confusion_eval_step,
                                          make_dp_seg_eval_step, shard_batch)
    mesh = _mesh()
    m = seg_model(sd)
    xs, ls = (torch.from_numpy(a) for a in shard_batch((x, labels), mesh))
    dice, logits = make_dp_seg_eval_step(N_CLASS, mesh)(sgd_state(m), xs, ls)
    cm_dice = make_dp_confusion_eval_step(N_CLASS, mesh)(sgd_state(m), xs,
                                                         ls)
    return dice.numpy(), logits.numpy(), cm_dice.numpy()


def w_dp_reg_step(sd, mov, fix):
    from deepatlas_torch.losses import get_loss_function as g
    from deepatlas_torch.parallel import make_dp_reg_train_step, shard_batch
    mesh = _mesh()
    m = vm_model(sd)
    step = make_dp_reg_train_step(g("lncc")(filter_size=9),
                                  g("bendingEnergy")(), 0.5, mesh)
    ms, fs = shard_batch((mov, fix), mesh)
    _, metrics = step(sgd_state(m), torch.from_numpy(ms),
                      torch.from_numpy(fs))
    return ({k: float(v) for k, v in metrics.items()},
            {k: v.numpy() for k, v in m.state_dict().items()})


def joint_kwargs(hard):
    from functools import partial

    from deepatlas_torch.kernels import grid_sample
    kw = dict(warp_fn=partial(grid_sample, max_disp=8), max_disp=8,
              two_pass=True, hard_fused=hard, fused_anatomy=hard)
    kw["seg_warp_fn"] = partial(grid_sample, max_disp=8, grad="values")
    return kw


def w_dp_joint(seg_sd, reg_sd, BN, sup_name, hard, arrays, flags,
               sup_weight=1.0):
    from deepatlas_torch.losses import get_loss_function as g
    from deepatlas_torch.parallel import make_dp_joint_steps, shard_batch
    mesh = _mesh()
    reg_step, seg_step = make_dp_joint_steps(
        g("lncc")(filter_size=9), g("bendingEnergy")(), criterion(sup_name),
        0.5, 0.3, sup_weight, N_CLASS, mesh, **joint_kwargs(hard))
    shards = [torch.from_numpy(a) for a in shard_batch(arrays, mesh)]
    flags = [torch.from_numpy(f) for f in shard_batch(flags, mesh)]
    seg, reg = seg_model(seg_sd, BN), vm_model(reg_sd)
    _, rm = reg_step(sgd_state(reg), sgd_state(seg_model(seg_sd, BN)),
                     *shards, *flags)
    _, sm = seg_step(sgd_state(seg), sgd_state(vm_model(reg_sd)), *shards,
                     *flags)
    return ({k: float(v) for k, v in rm.items()},
            {k: float(v) for k, v in sm.items()},
            {k: v.numpy() for k, v in reg.state_dict().items()},
            {k: v.numpy() for k, v in seg.state_dict().items()})


def w_experiment(config):
    import torch.distributed as dist

    from deepatlas_torch.train import SegmentationExperiment
    exp = SegmentationExperiment(config)
    exp.train()
    dice = exp.test()[1]
    return (dist.get_rank(), exp.is_writer, dice,
            {k: v.numpy() for k, v in exp.model.state_dict().items()})


# ----------------------------------------------------------------- tests

def test_dp_seg_step_matches_single_with_a_batch_mean_loss(ranks2):
    import jax.numpy as jnp

    from deepatlas_torch.train import make_seg_train_step
    x, labels = seg_inputs(2)
    _, _, sd = jax_seg(jnp.asarray(x[:1]), BN=False)
    res = ranks2.run(w_dp_seg_step, sd, False, "cross_entropy", x, labels)
    m = seg_model(sd, BN=False)
    _, loss, _ = make_seg_train_step(criterion("cross_entropy"))(
        sgd_state(m), torch.from_numpy(x), torch.from_numpy(labels))
    for r_loss, _ in res:
        np.testing.assert_allclose(r_loss, float(loss), rtol=1e-5)
    close_state([s for _, s in res],
                {k: v.numpy() for k, v in m.state_dict().items()}, 2e-5)


def test_dp_seg_step_matches_jax_dp(ranks2):
    """Per-replica BatchNorm moments, the loss, gradients and new running
    statistics averaged: the JAX ``make_dp_seg_train_step``."""
    import jax.numpy as jnp

    from deepatlas_tpu.losses import get_loss_function as jax_loss
    from deepatlas_tpu.parallel import (make_dp_seg_train_step, replicate,
                                        shard_batch)
    from deepatlas_torch.models import UNetTemplate, unet_from_flax
    from test_torch_spatial import SEG_PLAN
    x, labels = seg_inputs(2)
    model, sv, sd = jax_seg(jnp.asarray(x[:1]))
    res = ranks2.run(w_dp_seg_step, sd, True, "dice", x, labels)
    mesh = jax_dp_mesh()
    step = make_dp_seg_train_step(jax_loss("dice")(
        n_class=N_CLASS, weight_type="Uniform", softmax=True), mesh)
    js, jloss, _ = step(replicate(jax_state(model, sv), mesh),
                        *shard_batch((jnp.asarray(x),
                                      jnp.asarray(labels.astype(np.int32))),
                                     mesh))
    for r_loss, _ in res:
        np.testing.assert_allclose(r_loss, float(jloss), rtol=1e-5)
    close_state([s for _, s in res],
                jax_params_sd(js, UNetTemplate(bias=False, BN=True,
                                               **SEG_PLAN), unet_from_flax),
                2e-5)


def test_dp_eval_and_confusion_match_single_and_jax(ranks2):
    import jax.numpy as jnp

    from deepatlas_tpu.parallel import (make_dp_confusion_eval_step,
                                        make_dp_seg_eval_step, replicate,
                                        shard_batch)
    from deepatlas_torch.metrics.confusion import (confusion_matrix,
                                                   dice_from_confusion)
    from deepatlas_torch.train import make_seg_eval_step
    x, labels = seg_inputs(2)
    model, sv, sd = jax_seg(jnp.asarray(x[:1]))
    res = ranks2.run(w_dp_eval, sd, x, labels)
    m = seg_model(sd)
    dice_ref, logits_ref = make_seg_eval_step(N_CLASS)(
        sgd_state(m), torch.from_numpy(x), torch.from_numpy(labels))
    cm_ref = dice_from_confusion(confusion_matrix(
        logits_ref.argmax(-1), torch.from_numpy(labels), N_CLASS), 1e-11)[1:]
    for dice, _, cm_dice in res:
        close(dice, dice_ref, 1e-5)
        close(cm_dice, cm_ref, 1e-5)
    close(np.concatenate([lg for _, lg, _ in res]), logits_ref, 2e-5)
    mesh = jax_dp_mesh()
    st = replicate(jax_state(model, sv), mesh)
    batch = shard_batch((jnp.asarray(x), jnp.asarray(labels.astype(
        np.int32))), mesh)
    jdice, _ = make_dp_seg_eval_step(N_CLASS, mesh)(st, *batch)
    close(res[0][0], jdice, 1e-5)
    close(res[0][2], make_dp_confusion_eval_step(N_CLASS, mesh)(st, *batch),
          1e-5)


def test_dp_reg_step_matches_single_and_jax(ranks2):
    import jax.numpy as jnp

    from deepatlas_tpu.losses import get_loss_function as jax_loss
    from deepatlas_tpu.parallel import (make_dp_reg_train_step, replicate,
                                        shard_batch)
    from deepatlas_torch.losses import get_loss_function as g
    from deepatlas_torch.models import VoxelMorphCVPR2018, voxelmorph_from_flax
    from deepatlas_torch.train import make_reg_train_step
    from test_torch_spatial import VM_PLAN
    mov, fix = vm_inputs(2)
    model, sv, sd = jax_vm(jnp.asarray(mov[:1]), jnp.asarray(fix[:1]))
    res = ranks2.run(w_dp_reg_step, sd, mov, fix)
    m = vm_model(sd)
    _, metrics = make_reg_train_step(g("lncc")(filter_size=9),
                                     g("bendingEnergy")(), 0.5)(
        sgd_state(m), torch.from_numpy(mov), torch.from_numpy(fix))
    ref_sd = {k: v.numpy() for k, v in m.state_dict().items()}
    for r, _ in res:
        for k in ("loss", "sim", "reg"):
            np.testing.assert_allclose(r[k], float(metrics[k]), rtol=1e-5,
                                       err_msg=k)
    close_state([s for _, s in res], ref_sd, 2e-5)
    mesh = jax_dp_mesh()
    # the JAX model's XLA warp is unclamped: the field is far below 8
    # voxels here (flow_scale 0.1), so the port's clamp is inactive
    step = make_dp_reg_train_step(jax_loss("lncc")(filter_size=9),
                                  jax_loss("bendingEnergy")(), 0.5, mesh)
    js, jm = step(replicate(jax_state(model, sv), mesh),
                  *shard_batch((jnp.asarray(mov), jnp.asarray(fix)), mesh))
    for k in ("loss", "sim", "reg"):
        np.testing.assert_allclose(res[0][0][k], float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    close_state([s for _, s in res],
                jax_params_sd(js, VoxelMorphCVPR2018(**VM_PLAN),
                              voxelmorph_from_flax), 2e-5)


def joint_batch(seed=5):
    mov, fix = vm_inputs(2)
    rng = np.random.RandomState(seed)
    mseg = rng.randint(0, N_CLASS, (2, 64, 16, 16)).astype(np.int64)
    fseg = rng.randint(0, N_CLASS, (2, 64, 16, 16)).astype(np.int64)
    return (mov, fix, mseg, fseg)


# (hard_fused, moving flags, fixed flags, supervised weight).  A side
# labelled on one replica only is supervised over that replica's rows but,
# in one process, over the whole batch (the reference's branch rule), so
# the supervised term is held where each side's flags agree, and switched
# off where the replicas take different regimes (hard on rank 0, f_hard on
# rank 1, f_hard in one process).
JOINT_CASES = [(False, (True, True), (False, False), 1.0),
               (True, (True, True), (False, False), 1.0),
               (True, (True, False), (True, True), 0.0)]


@pytest.mark.parametrize("hard,m_has,f_has,sup_weight", JOINT_CASES)
def test_dp_joint_steps_match_single(ranks2, hard, m_has, f_has,
                                     sup_weight):
    """Each replica resolves its own rows' regime; the supervised weight
    counts the labelled branches of both replicas."""
    import jax.numpy as jnp

    from deepatlas_torch.losses import get_loss_function as g
    from deepatlas_torch.train import make_joint_reg_step, make_joint_seg_step
    arrays = joint_batch()
    flags = (np.array(m_has), np.array(f_has))
    _, _, seg_sd = jax_seg(jnp.asarray(arrays[0][:1]), BN=False)
    _, _, reg_sd = jax_vm(jnp.asarray(arrays[0][:1]),
                          jnp.asarray(arrays[1][:1]))
    res = ranks2.run(w_dp_joint, seg_sd, reg_sd, False, "cross_entropy",
                     hard, arrays, flags, sup_weight)
    kw = joint_kwargs(hard)
    ref_reg = make_joint_reg_step(
        g("lncc")(filter_size=9), g("bendingEnergy")(), 0.5, 0.3, N_CLASS,
        warp_fn=kw["warp_fn"], max_disp=8, fused_anatomy=hard)
    ref_seg = make_joint_seg_step(criterion("cross_entropy"), 0.3,
                                  sup_weight, N_CLASS,
                                  warp_fn=kw["seg_warp_fn"],
                                  hard_fused=hard, max_disp=8)
    args = [torch.from_numpy(a) for a in arrays] + \
        [torch.from_numpy(f) for f in flags]
    reg, seg = vm_model(reg_sd), seg_model(seg_sd, BN=False)
    _, rm = ref_reg(sgd_state(reg), sgd_state(seg_model(seg_sd, False)),
                    *args)
    _, sm = ref_seg(sgd_state(seg), sgd_state(vm_model(reg_sd)), *args)
    for r_rm, r_sm, r_reg, r_seg in res:
        for k in ("loss", "sim", "reg", "anatomy", "disp_overflow"):
            np.testing.assert_allclose(r_rm[k], float(rm[k]), rtol=2e-5,
                                       atol=1e-7, err_msg=k)
        for k in ("loss", "anatomy", "supervised")[:3 if sup_weight else 2]:
            np.testing.assert_allclose(r_sm[k], float(sm[k]), rtol=2e-5,
                                       err_msg=k)
        close_state([r_reg], {k: v.numpy()
                              for k, v in reg.state_dict().items()}, 3e-5)
        close_state([r_seg], {k: v.numpy()
                              for k, v in seg.state_dict().items()}, 3e-5)


def test_dp_joint_steps_match_jax_dp(ranks2):
    """The soft two-pass path with BatchNorm and the dice supervised loss
    (per-replica moments and class weights) against the JAX
    ``make_dp_joint_steps`` on a 2-device mesh; the moving side of rank 1
    is unlabelled, so the global labelled count (3 of 4) weighs the
    supervised terms."""
    import jax.numpy as jnp

    from deepatlas_tpu.losses import get_loss_function as jax_loss
    from deepatlas_tpu.parallel import (make_dp_joint_steps, replicate,
                                        shard_batch)
    from deepatlas_torch.models import (UNetTemplate, VoxelMorphCVPR2018,
                                        unet_from_flax, voxelmorph_from_flax)
    from test_torch_spatial import SEG_PLAN, VM_PLAN
    arrays = joint_batch()
    flags = (np.array([True, False]), np.array([True, True]))
    seg_jm, seg_sv, seg_sd = jax_seg(jnp.asarray(arrays[0][:1]))
    reg_jm, reg_sv, reg_sd = jax_vm(jnp.asarray(arrays[0][:1]),
                                    jnp.asarray(arrays[1][:1]))
    res = ranks2.run(w_dp_joint, seg_sd, reg_sd, True, "dice", False,
                     arrays, flags)
    mesh = jax_dp_mesh()
    jreg, jseg = make_dp_joint_steps(
        jax_loss("lncc")(filter_size=9), jax_loss("bendingEnergy")(),
        jax_loss("dice")(n_class=N_CLASS, weight_type="Uniform",
                         softmax=True),
        0.5, 0.3, 1.0, N_CLASS, mesh)
    batch = shard_batch(tuple(jnp.asarray(a) for a in arrays)
                        + tuple(jnp.asarray(f) for f in flags), mesh)
    rs, rm = jreg(replicate(jax_state(reg_jm, reg_sv), mesh),
                  replicate(jax_state(seg_jm, seg_sv), mesh), *batch)
    ss, sm = jseg(replicate(jax_state(seg_jm, seg_sv), mesh),
                  replicate(jax_state(reg_jm, reg_sv), mesh), *batch)
    for r_rm, r_sm, r_reg, r_seg in res:
        for k in ("loss", "sim", "reg", "anatomy"):
            np.testing.assert_allclose(r_rm[k], float(rm[k]), rtol=2e-5,
                                       err_msg=k)
        for k in ("loss", "anatomy", "supervised"):
            np.testing.assert_allclose(r_sm[k], float(sm[k]), rtol=2e-5,
                                       err_msg=k)
        close_state([r_reg], jax_params_sd(rs, VoxelMorphCVPR2018(**VM_PLAN),
                                           voxelmorph_from_flax), 3e-5)
        close_state([r_seg], jax_params_sd(ss, UNetTemplate(
            bias=False, BN=True, **SEG_PLAN), unet_from_flax), 3e-5)


def make_corpus(root, shape, names):
    from deepatlas_torch.data import NiftiImage, write_nifti
    rng = np.random.RandomState(7)
    img_dir = root / "image_in_MNI152_normalized"
    seg_dir = root / "label_31_reID_merged"
    img_dir.mkdir(parents=True)
    seg_dir.mkdir(parents=True)
    d, h, w = shape
    for name in names:
        seg = np.zeros(shape, np.uint8)
        seg[d // 4:d // 2, h // 4:h // 2, w // 4:w // 2] = 1
        seg[d // 2:3 * d // 4, h // 2:3 * h // 4, w // 2:3 * w // 4] = 2
        img = seg.astype(np.float32) / 3 + rng.rand(*shape).astype(
            np.float32) * 0.1
        write_nifti(img_dir / f"{name}.nii.gz", NiftiImage(img))
        write_nifti(seg_dir / f"{name}.nii.gz", NiftiImage(seg))
    for list_name in ("train.txt", "valid.txt", "test.txt"):
        (root / list_name).write_text("".join(f"{n}\n" for n in names))


def seg_config(root, **kw):
    config = dict(
        debug_mode=False, resume_dir="", random_seed=230, data="MindBoggle",
        n_epochs=1, samples_per_epoch=4, batch_size=1, valid_batch_size=1,
        print_batch_period=2, valid_epoch_period=1, save_ckpts_epoch_period=1,
        model="UNet_light",
        model_settings={"in_channel": 1, "n_classes": N_CLASS, "bias": True,
                        "BN": True},
        n_classes=N_CLASS, crop_size=[2, 3, 2], loss="dice",
        loss_settings={"n_class": N_CLASS, "weight_type": "Uniform",
                       "no_bg": False, "softmax": True, "eps": 1e-6},
        learning_rate=1e-2, lr_mode="multiStep", milestones=[0.5, 1],
        gamma=0.2, num_samples=2, preload=True, device="cpu",
        data_dir=str(root), valid_data_dir=str(root),
        training_list_file=str(root / "train.txt"),
        validation_list_file=str(root / "valid.txt"),
        testing_list_file=str(root / "test.txt"),
        log_dir=str(root / "logs"))
    config.update(kw)
    return config


@pytest.mark.parametrize("tier", ["data_parallel", "spatial_shards"])
def test_seg_experiment_runs_on_both_tiers(ranks2, tmp_path, tier):
    """The seg experiment trains an epoch, validates and tests at 2 ranks:
    the replicas end with the same parameters, rank 0 alone writes the logs
    and checkpoints, the test dice is every rank's."""
    names = [f"scan{i}" for i in range(3)]
    # the spatial tier needs a depth each shard's U-Net levels divide
    shape = (12, 14, 12) if tier == "data_parallel" else (20, 14, 12)
    make_corpus(tmp_path, shape, names)
    kw = ({"data_parallel": True, "batch_size": 2}
          if tier == "data_parallel" else {"spatial_shards": 2})
    res = ranks2.run(w_experiment, seg_config(tmp_path, **kw))
    assert [r[:2] for r in res] == [(0, True), (1, False)]
    assert res[0][2] == res[1][2] and np.isfinite(res[0][2])
    close_state([res[1][3]], res[0][3], 0.0)
    run_dir = next((tmp_path / "logs").iterdir())
    files = {p.name for p in run_dir.rglob("*") if p.is_file()}
    assert {"checkpoint", "scalars.jsonl", "train_config.json",
            "test_log.txt"} <= files
