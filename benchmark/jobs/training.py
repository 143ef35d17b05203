"""What the training jobs share: the MindBoggle corpus, the experiment's
feed, the record of its first steps, and the checks against the reference.

Set-up builds the experiment once, as its CLI does, loads weights drawn
from the seed into its networks, and drives it through its first three
steps by its own ``train_one_epoch`` and loader; the window then goes on
with that same experiment.  The reference follows those three steps from
the same weights on the same volumes, and the check compares each step's
loss, each network's first gradient as its Adam holds it after one step,
and each leaf's change after the three.
"""
from __future__ import annotations

import gc
import os
import shutil
from typing import Dict, List

import numpy as np
import torch

import corpus
import weights
from harness import Context, WindowClosed
from reference import steps as ref_steps
from reference.precision import Precision

CHECKED_STEPS = 3
# one in this many window batches is copied and compared with the arrays
# the benchmark wrote
DATA_SAMPLE = 16
ADAM_B1 = 0.9


def sub_seed(seed: int, stream: int) -> int:
    return int(np.random.SeedSequence([seed, stream]).generate_state(1)[0])


class Feed:
    """The experiment's batch iterator, wrapped: every ``next`` closes the
    previous step's unit at the window (the experiment has read the step's
    metrics, so the device is done with it), records the batch's names and
    copies a sample of batches for the data check."""

    def __init__(self, job, it):
        self.job, self.it = job, it
        self.live = False
        self.pending = None
        self.index = 0
        self.names: List = []
        self.copies: List = []
        self.rng = np.random.default_rng([job.ctx.seed, 7])

    def epoch_start(self):
        self.index = 0

    def __iter__(self):
        return self

    def __next__(self):
        ctx = self.job.ctx
        if self.live and self.pending is not None:
            kind, self.pending = self.pending, None
            ctx.window.boundary(kind, self.job.batch_size)
        with ctx.spans("data.wait"):
            batch = next(self.it)
        sides = batch if isinstance(batch, tuple) else (batch,)
        names = tuple(tuple(s["name"]) for s in sides)
        if not self.live:
            self.names.append(names)
        if not self.live or self.rng.random() < 1.0 / DATA_SAMPLE:
            self.copies.append([(n, s["image"].copy(),
                                 s["segmentation"].copy())
                                for n, s in zip(names, sides)])
        self.pending = self.job.kind_of(self.index, names)
        self.index += 1
        return batch

    def close(self):
        close = getattr(self.it, "close", None)
        if close is not None:
            close()


class TrainingJob:
    """Base of the seg and joint jobs; subclasses build the experiment
    (``build``), name a step's kind (``kind_of``), wrap the step functions
    that record the first steps (``wrap_steps``) and run the reference
    (``reference``)."""
    step_attrs: tuple = ()

    def __init__(self, ctx: Context):
        self.ctx, self.config, self.traffic = ctx, ctx.config, ctx.traffic
        self.batch_size = self.config["batch_size"]
        self.exp = None
        self.feed = None
        self.losses: List[float] = []
        self.first_grads: Dict[str, Dict[str, torch.Tensor]] = {}
        self.start_params: Dict[str, Dict[str, torch.Tensor]] = {}
        self.end_params: Dict[str, Dict[str, torch.Tensor]] = {}
        self.arrays = {}
        self.diagnostics = {}

    # ------------------------------------------------------------- set-up
    def write_data(self):
        cfg = self.config
        root = os.path.join(self.ctx.workdir, "data")
        names, self.arrays, _ = corpus.write_corpus(
            "mindboggle", root, sub_seed(self.ctx.seed, 1),
            cfg["n_volumes"], cfg["volume_shape"], cfg["n_classes"])
        mb = os.path.join(root, "mindboggle")
        corpus.write_list(os.path.join(mb, "MMRR-21-flip.txt"), names)
        corpus.write_list(os.path.join(mb, "NKI-RS-21-valid.txt"), names[:1])
        corpus.write_list(os.path.join(mb, "NKI-RS-21-train.txt"), names[:1])
        self.names = names
        return root, mb

    def recipe_paths(self, root, mb) -> dict:
        return dict(
            data_dir=mb, valid_data_dir=mb,
            training_list_file=(os.path.join(mb, "MMRR-21-flip.txt"),),
            validation_list_file=os.path.join(mb, "NKI-RS-21-valid.txt"),
            testing_list_file=os.path.join(mb, "NKI-RS-21-train.txt"),
            log_dir=os.path.join(self.ctx.workdir, "logs"),
            device=str(self.ctx.device), preload=self.traffic["preload"],
            num_workers=self.traffic.get("num_workers"),
            random_seed=sub_seed(self.ctx.seed, 2) % (2 ** 31),
            num_samples=self.config["n_volumes"])

    def specs(self) -> Dict[str, list]:
        """``{net name: parameter spec}`` (``reference.nets``)."""
        raise NotImplementedError

    def modules(self) -> Dict[str, tuple]:
        """``{net name: (module, optimizer)}`` of the experiment."""
        raise NotImplementedError

    def weights_of(self, i: int, spec) -> dict:
        return weights.make_weights(spec, sub_seed(self.ctx.seed, 10 + i),
                                    self.ctx.device)

    def setup(self):
        self.build()
        mods = self.modules()
        for i, (net, spec) in enumerate(self.specs().items()):
            module = mods[net][0]
            module.load_state_dict(self.weights_of(i, spec), strict=True)
            self.start_params[net] = {k: v.detach().clone()
                                      for k, v in module.named_parameters()}
        self.feed = Feed(self, self.exp._train_iter)
        self.exp._train_iter = self.feed
        # the first steps, through the experiment's own call and feed
        epoch = self.exp.config["samples_per_epoch"]
        self.exp.config["samples_per_epoch"] = CHECKED_STEPS * self.batch_size
        self.wrap_steps(record=True)
        self.exp.train_one_epoch()
        self.wrap_steps(record=False)
        self.exp.config["samples_per_epoch"] = epoch
        for net, (module, _) in self.modules().items():
            self.end_params[net] = {k: v.detach().clone()
                                    for k, v in module.named_parameters()}
        self.warm_up()
        self.instrument()

    def instrument(self):
        """The benchmark's spans around the experiment's step calls and its
        host-to-device copies, put back when the experiment rebuilds its
        steps (the joint experiment's displacement guard does)."""
        exp, spans = self.exp, self.ctx.spans

        def spanned(fn, name):
            def call(*a, **kw):
                with spans(name):
                    return fn(*a, **kw)
            call.spanned = True
            return call

        for attr in self.step_attrs + ("_to_device",):
            fn = getattr(exp, attr)
            if not getattr(fn, "spanned", False):
                setattr(exp, attr, spanned(fn, attr.strip("_")))
        build = getattr(exp, "_build_steps", None)
        if build is not None and not getattr(build, "spanned", False):
            def rebuild():
                build()
                self.instrument()
            rebuild.spanned = True
            exp._build_steps = rebuild

    def warm_up(self):
        """Run every step variant the window will run (none beyond the
        first steps by default)."""

    def record_first_grads(self, net: str):
        if net in self.first_grads:
            return
        module, opt = self.modules()[net]
        self.first_grads[net] = {
            k: opt.state[p]["exp_avg"].detach() / (1 - ADAM_B1)
            if "exp_avg" in opt.state.get(p, {}) else torch.zeros_like(p)
            for k, p in module.named_parameters()}

    # ------------------------------------------------------------- window
    def run_window(self):
        self.wait0 = self.exp.training_data_loader.wait_seconds
        self.feed.live = True
        self.feed.pending = None
        try:
            while True:
                self.feed.epoch_start()
                self.exp.train_one_epoch()
        except WindowClosed:
            pass

    def close_window(self):
        self.feed.live = False
        self.ctx.counters["loader_wait_s"] = \
            self.exp.training_data_loader.wait_seconds - self.wait0
        self.feed.close()
        self.exp.close()
        self.exp = None
        gc.collect()
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def end_to_end(self) -> dict:
        w = self.ctx.window
        n = sum(u.samples for u in w.units)
        return {"train_samples_per_s": n / w.elapsed}

    # -------------------------------------------------------------- check
    def data_mismatch(self) -> float:
        crop = self.config.get("crop_size") or [0] * 6
        bad = 0
        for batch in self.feed.copies:
            for names, image, labels in batch:
                for b, name in enumerate(names):
                    img, seg = self.arrays[name]
                    d, h, w = img.shape
                    sl = (slice(crop[0], d - crop[3]),
                          slice(crop[1], h - crop[4]),
                          slice(crop[2], w - crop[5]))
                    want = np.clip(img[sl], 0.0, 1.0)
                    bad += int((image[b, ..., 0] != want).sum())
                    bad += int((labels[b] != seg[sl]).sum())
        return float(bad)

    def batch_tensors(self, names, device):
        """Images ``(B, 1, D, H, W)`` and labels of the named volumes from
        the arrays the benchmark wrote, cropped as the recipe crops."""
        crop = self.config.get("crop_size") or [0] * 6
        imgs, segs = [], []
        for name in names:
            img, seg = self.arrays[name]
            d, h, w = img.shape
            sl = (slice(crop[0], d - crop[3]), slice(crop[1], h - crop[4]),
                  slice(crop[2], w - crop[5]))
            imgs.append(np.clip(img[sl], 0.0, 1.0))
            segs.append(seg[sl].astype(np.int64))
        x = torch.from_numpy(np.stack(imgs)[:, None]).to(device)
        return x, torch.from_numpy(np.stack(segs)).to(device)

    def reference_nets(self) -> Dict[str, ref_steps.Net]:
        return {net: ref_steps.Net(self.weights_of(i, spec), spec,
                                   self.config["learning_rate"])
                for i, (net, spec) in enumerate(self.specs().items())}

    def follow(self, prec: Precision):
        """The reference through the recorded first steps: ``(losses,
        first gradients, changes)``, each by network."""
        refs = self.reference_nets()
        start = {n: {k: v.detach().clone() for k, v in r.params.items()}
                 for n, r in refs.items()}
        losses = self.reference(refs, prec)
        grads = {n: r.opt.first_grads for n, r in refs.items()}
        change = {n: {k: refs[n].params[k].detach() - start[n][k]
                      for k in start[n]} for n in refs}
        return losses, grads, change

    def gaps(self, losses, grads, change, ref, label="program") -> dict:
        """The numbers read: each step's loss (the worst and the first),
        the first gradients by leaf (the worst and the median leaf), and
        the worst leaf's change over the leaves whose reference gradient is
        at least a thousandth of the median leaf's.  What each number was
        read from goes to ``diagnostics[label]``."""
        ref_losses, ref_grads, ref_change = ref
        rel = [abs(a - b) / max(abs(b), 1e-30)
               for a, b in zip(losses, ref_losses)]
        if len(rel) < len(ref_losses):
            rel.append(float("inf"))
        g_gaps, u_gaps, worst = {}, {}, {}
        for net in ref_grads:
            rg = ref_steps.leaf_norms(ref_grads[net])
            pg = ref_steps.leaf_norms(grads[net])
            for k, v in ref_steps.leaf_gaps(pg, rg).items():
                g_gaps[f"{net}.{k}"] = v
                worst[f"grad {net}.{k}"] = (v, pg[k], rg[k])
            med = sorted(rg.values())[len(rg) // 2]
            keep = {k for k, v in rg.items() if v >= 1e-3 * med}
            pc = ref_steps.leaf_norms(change[net])
            rc = ref_steps.leaf_norms(ref_change[net])
            for k, v in ref_steps.leaf_gaps(pc, rc, keep).items():
                u_gaps[f"{net}.{k}"] = v
                worst[f"change {net}.{k}"] = (v, pc[k], rc[k])
        top = sorted(worst.items(), key=lambda kv: -kv[1][0])[:6]
        self.diagnostics[label] = {"losses": list(losses),
                                   "reference_losses": list(ref_losses),
                                   "worst_leaves": top}
        g, u = list(g_gaps.values()), list(u_gaps.values())
        return {"loss_gap": max(rel), "loss1_gap": rel[0],
                "grad_gap": max(g), "grad_median_gap": float(np.median(g)),
                "update_gap": max(u)}

    def readings(self) -> dict:
        ref = self.follow(Precision("float32"))
        change = {n: {k: self.end_params[n][k] - self.start_params[n][k]
                      for k in self.start_params[n]}
                  for n in self.start_params}
        out = self.gaps(self.losses, self.first_grads, change, ref)
        out["data_mismatch"] = self.data_mismatch()
        self._ref = ref
        return out

    def control_readings(self) -> dict:
        """The control in the program's place: the reference computed with
        float8 convolutions, against the float32 reference."""
        ref = getattr(self, "_ref", None) or self.follow(Precision("float32"))
        return self.gaps(*self.follow(Precision("fp8")), ref,
                         label="control")

    def cleanup(self):
        if self.feed is not None:
            self.feed.close()
        if self.exp is not None:
            self.exp.close()
        shutil.rmtree(self.ctx.workdir, ignore_errors=True)


def wrap(fn, after):
    """``fn`` followed by ``after(result)``."""
    def wrapped(*args, **kw):
        out = fn(*args, **kw)
        after(out)
        return out
    return wrapped

