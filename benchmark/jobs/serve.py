"""Whole-volume serving, ``infer_seg_torch.py``'s path on OAI volumes: the
port's OAI dataset and ``DataLoader`` read each ``.nii.gz`` image and mask,
``make_tile_predictor``, ``sliding_window_predict`` and ``volume_dice``
label it by overlap tiles and score it.  One caller labels a cohort that
lists a few distinct volumes over and over, one volume after another."""
from __future__ import annotations

import os
import shutil
import time

import numpy as np
import torch

import corpus
import weights
from harness import Context, WindowClosed
from jobs.training import sub_seed
from reference import nets, tiling
from reference import nifti as ref_nifti
from reference.precision import Precision, exact_float32


class Job:
    def __init__(self, ctx: Context):
        self.ctx, self.config, self.traffic = ctx, ctx.config, ctx.traffic
        self.it = None
        self.served = 0
        self.latencies = []
        self.kept = []          # the reservoir sample of served volumes
        self.rng = np.random.default_rng([ctx.seed, 5])
        self.predict_s = 0.0
        self._patched = []

    def setup(self):
        from deepatlas_torch.data import (Compose, DataLoader, VolumeToArray,
                                          get_seg_dataset)
        from deepatlas_torch.data.transforms import Partition
        from deepatlas_torch.models import get_network
        from deepatlas_torch.train import make_tile_predictor
        c, t, dev = self.config, self.traffic, self.ctx.device
        self.root = os.path.join(self.ctx.workdir, "data")
        names, self.arrays, _ = corpus.write_corpus(
            "oai", self.root, sub_seed(self.ctx.seed, 1), t["n_volumes"],
            c["volume_shape"], c["n_classes"])
        self.list_file = os.path.join(self.root, "cohort.txt")
        corpus.write_list(self.list_file, names * t["list_repeats"])
        self.spec = nets.unet_spec(c)
        self.weights = weights.make_weights(
            self.spec, sub_seed(self.ctx.seed, 10), dev, serving=True)
        self.centre_head(self.arrays[names[0]][0])
        model = get_network(c["model"])(
            in_channel=c["in_channel"], n_classes=c["n_classes"], bias=True,
            BN=True, dtype=torch.bfloat16)
        model.load_state_dict(self.weights, strict=True)
        self.model = model.to(dev).eval()
        predict = make_tile_predictor(self.model, c["tile_batch"])

        def timed_predict(tiles):
            t0 = time.perf_counter()
            with self.ctx.spans("predict"):
                out = predict(tiles)
            self.predict_s += time.perf_counter() - t0
            return out

        self.predict = timed_predict
        for attr, span in (("__call__", "tiling.partition"),
                           ("assemble", "tiling.assemble")):
            self._patch(Partition, attr, span)
        dataset = get_seg_dataset("OAI")(
            self.list_file, self.root, with_seg=True,
            pre_transform=Compose([VolumeToArray()]))
        self.loader = DataLoader(dataset, batch_size=1, shuffle=False,
                                 prefetch=t["prefetch"])
        self.it = iter(self.loader)
        # the first volume of the cohort, served in set-up: every shape the
        # window runs
        self.serve_one(record=False)

    def centre_head(self, image: np.ndarray):
        """Shift the drawn head's bias so that every class's mean logit over
        the central tile of ``image`` is zero, as a trained head balances
        its classes; a random head puts nearly every voxel in one class."""
        c, dev = self.config, self.ctx.device
        tile = c["tile"]
        lo = [(n - t) // 2 for n, t in zip(image.shape, tile)]
        x = np.clip(image[lo[0]:lo[0] + tile[0], lo[1]:lo[1] + tile[1],
                          lo[2]:lo[2] + tile[2]], 0.0, 1.0)
        stats = {k: v for k, v in self.weights.items()
                 if k.endswith(("running_mean", "running_var"))}
        with torch.no_grad(), exact_float32():
            logits = nets.unet_forward(
                c, self.weights, stats,
                torch.from_numpy(np.ascontiguousarray(x))[None, None].to(dev),
                False, Precision("float32"))
            self.weights["head.bias"] = self.weights["head.bias"] \
                - logits.mean(dim=(0, 2, 3, 4))

    def _patch(self, cls, attr, span):
        orig = getattr(cls, attr)
        spans = self.ctx.spans

        def wrapped(*a, **kw):
            with spans(span):
                return orig(*a, **kw)

        setattr(cls, attr, wrapped)
        self._patched.append((cls, attr, orig))

    def serve_one(self, record: bool):
        from deepatlas_torch.train import sliding_window_predict, volume_dice
        c, spans = self.config, self.ctx.spans
        t0 = time.perf_counter()
        with spans("data.wait"):
            try:
                batch = next(self.it)
            except StopIteration:     # the cohort's list, once more
                self.it = iter(self.loader)
                batch = next(self.it)
        sample = {"image": batch["image"][0], "like": batch["like"][0]}
        with spans("tiling"):
            pred = sliding_window_predict(self.predict, sample, c["tile"],
                                          c["overlap"])
        with spans("dice"):
            dice = volume_dice(pred, batch["segmentation"][0],
                               c["n_classes"], self.ctx.device)
        if not record:
            return
        self.latencies.append(time.perf_counter() - t0)
        k = self.traffic["checked_volumes"]
        slot = self.served if self.served < k else \
            int(self.rng.integers(0, self.served + 1))
        if slot < k:
            item = (batch["name"][0], batch["image"][0].copy(),
                    batch["segmentation"][0].copy(), pred, dice)
            if slot < len(self.kept):
                self.kept[slot] = item
            else:
                self.kept.append(item)
        self.served += 1

    def run_window(self):
        self.wait0 = self.loader.wait_seconds
        self.predict_s = 0.0
        self.ctx.spans.seconds.clear()
        try:
            while True:
                self.serve_one(record=True)
                self.ctx.window.boundary("serve", 1)
        except WindowClosed:
            pass

    def close_window(self):
        n = max(self.served, 1)
        sec = self.ctx.spans.seconds
        self.ctx.counters.update(
            loader_wait_s=self.loader.wait_seconds - self.wait0,
            tiling_host_s_per_volume=(sec.get("tiling", 0.0)
                                      - self.predict_s) / n,
            volume_latency_s=list(self.latencies))
        self.it.close()
        self.it = None
        del self.model
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def end_to_end(self) -> dict:
        w = self.ctx.window
        return {"serve_volumes_per_s": self.served / w.elapsed}

    # -------------------------------------------------------------- check
    def _reference_logits(self, prec: Precision):
        """Stitched reference logits of each distinct sampled volume."""
        out = {}
        stats = {k: v for k, v in self.weights.items()
                 if k.endswith(("running_mean", "running_var"))}
        for name, *_ in self.kept:
            if name not in out:
                img = np.clip(self.arrays[name][0], 0.0, 1.0)
                out[name] = tiling.stitched_logits(
                    self.config, self.weights, stats, img, self.ctx.device,
                    prec, self.config["tile_batch"])
        return out

    def readings(self) -> dict:
        ref = self._reference_logits(Precision("float32"))
        self._ref = ref
        gap, mean_gap, flips, dice_gap, bad = 0.0, 0.0, 0.0, 0.0, 0
        for name, image, labels, pred, dice in self.kept:
            img, seg = self.arrays[name]
            bad += int((image[..., 0] != np.clip(img, 0.0, 1.0)).sum())
            bad += int((labels != seg).sum())
            served = torch.from_numpy(pred).to(self.ctx.device)
            gap = max(gap, tiling.label_gap(ref[name], served))
            mean_gap = max(mean_gap, tiling.label_gap_mean(ref[name], served))
            flips = max(flips, tiling.label_flip_share(ref[name], served))
            truth = ref_nifti.read(os.path.join(self.root,
                                                f"{name}_masks.nii.gz"))
            want = tiling.dice(pred, truth, self.config["n_classes"])
            dice_gap = max(dice_gap, float(np.abs(dice - want).max()))
        return {"label_gap": gap, "label_gap_mean": mean_gap,
                "label_flip_share": flips,
                "dice_gap": dice_gap, "data_mismatch": float(bad)}

    def control_readings(self) -> dict:
        """The float8 reference's labels in the program's place, judged by
        the float32 reference's logits."""
        ref = getattr(self, "_ref", None) or \
            self._reference_logits(Precision("float32"))
        ctl = self._reference_logits(Precision("fp8"))
        labels = {n: ctl[n].argmax(dim=0) for n in ctl}
        return {"label_gap": max(tiling.label_gap(ref[n], labels[n])
                                 for n in ctl),
                "label_gap_mean": max(tiling.label_gap_mean(ref[n],
                                                            labels[n])
                                      for n in ctl),
                "label_flip_share": max(tiling.label_flip_share(ref[n],
                                                                labels[n])
                                        for n in ctl)}

    def cleanup(self):
        for cls, attr, orig in self._patched:
            setattr(cls, attr, orig)
        self._patched = []
        if self.it is not None:
            self.it.close()
        shutil.rmtree(self.ctx.workdir, ignore_errors=True)
