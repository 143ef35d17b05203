"""Segmentation training, ``train_seg_torch.py``'s recipe on whole
MindBoggle volumes: ``SegmentationExperiment.train_one_epoch`` over the
written ``.nii.gz`` corpus, read every step (``preload`` false) or decoded
once in set-up (``preload`` true)."""
from __future__ import annotations

from jobs.training import TrainingJob, wrap
from reference import nets
from reference import steps as ref_steps

CLI_KEYS = ("n_classes", "crop_size", "learning_rate", "batch_size")


def recipe(cli_module, argv, config) -> dict:
    """The CLI's own config for ``argv``, after checking that it runs the
    configuration file's numbers (a configuration ``shrunk`` for a CPU test
    replaces them instead)."""
    cfg = cli_module.build_config(cli_module.parse_args(argv))
    for key in CLI_KEYS:
        got = cfg[key]
        got = list(got) if isinstance(got, (list, tuple)) else got
        if config.get("shrunk"):
            cfg[key] = config[key]
        elif got != config[key]:
            raise ValueError(f"the recipe's {key} {got!r} is not the "
                             f"configuration's {config[key]!r}")
    return cfg


class Job(TrainingJob):
    step_attrs = ("train_step",)

    def build(self):
        import train_seg_torch
        from deepatlas_torch.data import endless
        from deepatlas_torch.train import SegmentationExperiment
        root, mb = self.write_data()
        argv = ["--data-root", root, "--log-root", self.ctx.workdir,
                "--num-samples", str(self.config["n_volumes"]),
                "--lr", repr(self.config["learning_rate"])]
        cfg = recipe(train_seg_torch, argv, self.config)
        cfg.update(self.recipe_paths(root, mb))
        cfg["model_settings"] = dict(cfg["model_settings"])
        self.exp = exp = SegmentationExperiment(cfg)
        exp.setup_train()
        exp._init_state()
        exp._train_iter = endless(exp.training_data_loader)

    def specs(self):
        return {"seg": nets.unet_spec(self.config)}

    def modules(self):
        return {"seg": (self.exp.model, self.exp.state.optimizer)}

    def kind_of(self, index, names) -> str:
        return "seg"

    def wrap_steps(self, record: bool):
        exp = self.exp
        if not record:
            exp.train_step = self._plain_step
            return
        self._plain_step = exp.train_step

        def after(out):
            self.losses.append(float(out[1]))
            self.record_first_grads("seg")

        exp.train_step = wrap(self._plain_step, after)

    def reference(self, refs, prec):
        losses = []
        for (names,) in self.feed.names:
            x, y = self.batch_tensors(names, self.ctx.device)
            losses.append(ref_steps.seg_step(self.config, refs["seg"], x, y,
                                             prec))
        return losses

