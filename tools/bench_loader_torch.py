"""Time the port's data loader alone: how many samples a second its decode
pool supplies to the serving and loading cells, at several pool sizes.

    python tools/bench_loader_torch.py [--seconds 15] [--workers 1 2 0] \
        [--seed 1] [--out loader.jsonl]

Writes the benchmark's synthetic corpora from ``--seed``
(``benchmark/corpus.py``): 4 OAI volumes of 160x384x384 listed 250 times,
read as ``oai_serve_nifti`` reads them (``benchmark/jobs/serve.py``: the
OAI dataset, ``VolumeToArray``, batch 1, prefetch 2), and 21 MindBoggle
volumes shuffled as ``mb101_seg_nifti``'s experiment reads them
(``VolumeToArray``, the recipe's crop to 168x200x168, batch 1, prefetch 2).
For each corpus and pool size (0 in ``--workers``: the loader's own default)
it iterates the loader (``endless``) with nothing consuming the batches:
one in-flight window to warm up, then ``--seconds`` timed.  One JSON line
each: samples a second, the pool's busy share (``decode_seconds`` over the
pool's thread seconds since the loader started), the mean read, and the
host memory the in-flight window and the buffer ring hold at most.  A
first line gives the host: usable CPUs, the affinity mask, the cgroup
quota, ``os.cpu_count()`` and the default pool.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "benchmark"))

import corpus  # noqa: E402  (benchmark/corpus.py)
from deepatlas_torch.data import (Compose, CropVolume, DataLoader,  # noqa: E402
                                  VolumeToArray, endless, get_seg_dataset)
from deepatlas_torch.data import loader as loader_mod  # noqa: E402


def config(name: str) -> dict:
    with open(os.path.join(REPO, "benchmark", "configs", name)) as f:
        return json.load(f)


def datasets(root: str, seed: int):
    """``{cell: dataset}`` over freshly written corpora."""
    oai, mb = config("oai_unet_light.json"), config("deepatlas_mb101.json")
    oai_root = os.path.join(root, "oai")
    names, _, _ = corpus.write_corpus("oai", oai_root, seed, 4,
                                      oai["volume_shape"], oai["n_classes"])
    corpus.write_list(os.path.join(oai_root, "cohort.txt"), names * 250)
    names, _, _ = corpus.write_corpus("mindboggle", root, seed + 1,
                                      mb["n_volumes"], mb["volume_shape"],
                                      mb["n_classes"])
    mb_root = os.path.join(root, "mindboggle")
    corpus.write_list(os.path.join(mb_root, "train.txt"), names)
    return {
        "oai_serve_nifti": get_seg_dataset("OAI")(
            os.path.join(oai_root, "cohort.txt"), oai_root, with_seg=True,
            pre_transform=Compose([VolumeToArray()])),
        "mb101_seg_nifti": get_seg_dataset("MindBoggle")(
            os.path.join(mb_root, "train.txt"), mb_root, with_seg=True,
            pre_transform=Compose([VolumeToArray(),
                                   CropVolume(mb["crop_size"])])),
    }


def measure(dataset, workers: int, seconds: float, shuffle: bool) -> dict:
    loader = DataLoader(dataset, batch_size=1, shuffle=shuffle, seed=3,
                        prefetch=2, num_workers=workers or None)
    window = loader.num_workers + loader.batch_size * loader.prefetch
    start = time.perf_counter()
    it = endless(loader)
    first = next(it)
    sample_bytes = sum(v.nbytes for v in first.values()
                       if hasattr(v, "nbytes"))
    for _ in range(window):              # warm: the window is full
        next(it)
    d0, t0, n = loader.decode_seconds, time.perf_counter(), 0
    while time.perf_counter() - t0 < seconds:
        next(it)
        n += 1
    end, total = time.perf_counter(), loader.decode_seconds
    it.close()                  # (waits for the reads still in flight)
    decode = total - d0
    threads = max(loader.num_workers, 1)
    return {"workers": loader.num_workers, "samples": n,
            "seconds": end - t0, "samples_per_s": n / (end - t0),
            # the reads finished since the start, over the pool's time
            "pool_busy_share": total / (threads * (end - start)),
            "decode_ms_per_sample": 1e3 * decode / max(n, 1),
            "sample_mb": sample_bytes / 1e6,
            # decoded samples in the window, plus the ring's batches
            "window_host_gb": (window + loader.prefetch + 3)
            * sample_bytes / 1e9}


def host() -> dict:
    return {"host": os.uname().nodename,
            "usable_cpus": loader_mod.usable_cpus(),
            "affinity": len(os.sched_getaffinity(0)),
            "cgroup_quota_cpus": loader_mod._cgroup_cpu_quota(),
            "cpu_count": os.cpu_count(),
            "default_pool": loader_mod.host_num_workers()}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seconds", type=float, default=15.0)
    p.add_argument("--workers", type=int, nargs="+", default=[1, 2, 0])
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    lines = [host()]
    print(json.dumps(lines[0]), flush=True)
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        sets = datasets(root, args.seed)
        print(json.dumps({"corpora_written_s": time.perf_counter() - t0}),
              flush=True)
        for cell in sets:
            for workers in args.workers:
                line = {"cell": cell, **measure(
                    sets[cell], workers, args.seconds,
                    shuffle=cell != "oai_serve_nifti")}
                lines.append(line)
                print(json.dumps(line), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write("".join(json.dumps(x) + "\n" for x in lines))


if __name__ == "__main__":
    main()
