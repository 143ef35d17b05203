"""Joint DeepAtlas training, ``train_deepatlas_torch.py``'s recipe on whole
MindBoggle volumes of which the first ``n_labeled`` keep their labels:
``DeepAtlasExperiment.train_one_epoch`` alternating the seg and the reg
phase on ordered pairs drawn by the experiment's own loader."""
from __future__ import annotations

import torch

from jobs.seg import recipe
from jobs.training import TrainingJob, wrap
from reference import nets
from reference import steps as ref_steps

REGIMES = ("soft", "f_hard", "m_hard", "hard")
# (moving labelled, fixed labelled) of each warm-up step
SEG_FLAGS = ((False, False), (False, True), (True, False), (True, True))
REG_FLAGS = ((True, True), (True, False), (False, False))


class Job(TrainingJob):
    step_attrs = ("seg_step", "reg_step")

    def build(self):
        import train_deepatlas_torch
        from deepatlas_torch.data import endless
        from deepatlas_torch.train import DeepAtlasExperiment
        root, mb = self.write_data()
        c = self.config
        argv = ["--data-root", root, "--log-root", self.ctx.workdir,
                "--num-samples", str(self.config["n_volumes"]),
                "--n-labeled", str(self.config["n_labeled"]),
                "--lr", repr(c["learning_rate"]),
                "--reg-weight", repr(c["reg_weight"]),
                "--anatomy-weight", repr(c["anatomy_weight"]),
                "--supervised-weight", repr(c["supervised_weight"]),
                "--max-disp", str(c["max_disp"]),
                "--batch-size", str(c["batch_size"])]
        cfg = recipe(train_deepatlas_torch, argv, c)
        cfg.update(self.recipe_paths(root, mb))
        self.exp = exp = DeepAtlasExperiment(cfg)
        exp.setup_train()
        exp._init_state()
        exp._train_iter = endless(exp.training_data_loader)

    def specs(self):
        return {"seg": nets.unet_spec(self.config),
                "reg": nets.voxelmorph_spec(self.config)}

    def modules(self):
        e = self.exp
        return {"seg": (e.seg_model, e.seg_state.optimizer),
                "reg": (e.reg_model, e.reg_state.optimizer)}

    def labelled(self, names) -> bool:
        return all(n in self.names[:self.config["n_labeled"]]
                   for n in names)

    def kind_of(self, index, names) -> str:
        has_m, has_f = self.labelled(names[0]), self.labelled(names[1])
        if index % 2 == 0:
            return "joint_seg." + REGIMES[2 * has_m + has_f]
        return f"joint_reg.{2 - has_m - has_f}"

    def wrap_steps(self, record: bool):
        exp = self.exp
        if not record:
            exp.seg_step, exp.reg_step = self._plain
            return
        self._plain = (exp.seg_step, exp.reg_step)

        def after(net):
            def fn(out):
                self.losses.append(float(out[1]["loss"]))
                self.record_first_grads(net)
            return fn

        exp.seg_step = wrap(exp.seg_step, after("seg"))
        exp.reg_step = wrap(exp.reg_step, after("reg"))

    def warm_up(self):
        """One seg step in each label regime and one reg step at each count
        of substituted sides, on two of the written volumes."""
        exp, dev = self.exp, self.ctx.device
        x, y = self.batch_tensors(self.names[:2], dev)
        img_m, img_f = (t.permute(0, 2, 3, 4, 1).contiguous()
                        for t in (x[:1], x[1:]))
        seg_m, seg_f = y[:1], y[1:]
        for (hm, hf) in SEG_FLAGS:
            exp.seg_state, m = exp.seg_step(
                exp.seg_state, exp.reg_state, img_m, img_f, seg_m, seg_f,
                torch.tensor([hm]), torch.tensor([hf]))
            float(m["loss"])
        for (hm, hf) in REG_FLAGS:
            exp.reg_state, m = exp.reg_step(
                exp.reg_state, exp.seg_state, img_m, img_f, seg_m, seg_f,
                torch.tensor([hm]), torch.tensor([hf]))
            float(m["loss"])

    def reference(self, refs, prec):
        losses, dev = [], self.ctx.device
        for i, (m_names, f_names) in enumerate(self.feed.names):
            xm, ym = self.batch_tensors(m_names, dev)
            xf, yf = self.batch_tensors(f_names, dev)
            flags = (self.labelled(m_names), self.labelled(f_names))
            if i % 2 == 0:
                losses.append(ref_steps.joint_seg_step(
                    self.config, refs["seg"], refs["reg"], xm, xf, ym, yf,
                    *flags, prec))
            else:
                losses.append(ref_steps.joint_reg_step(
                    self.config, refs["reg"], refs["seg"], xm, xf, ym, yf,
                    *flags, prec))
        return losses
