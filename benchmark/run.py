"""Run one benchmark cell once:

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout that holds ``deepatlas_torch``.  The last line
of standard output is the result as one JSON object; the numbers compared
against the reference, each beside its limit, are the last lines of
standard error.  Without a CUDA device the run prints no result and exits
with a code other than 0.
"""
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, ROOT]
# every build and kernel cache of the program at a fixed path inside the
# checkout (the CUDA sources build into deepatlas_torch/kernels/_build/)
_BUILD = os.path.join(ROOT, "deepatlas_torch", "kernels", "_build")
os.environ["TRITON_CACHE_DIR"] = os.path.join(_BUILD, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(_BUILD, "torch_extensions")
os.environ["USE_FLAX"] = "0"

import harness  # noqa: E402

if __name__ == "__main__":
    harness.exit_now(harness.main())
