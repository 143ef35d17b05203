"""Joint DeepAtlas training on the overflow guard's settled rung: the joint
job with the guard's actions taken before the weights are loaded.

From the recipe's start (``max_disp`` 8, drawn weights) the reg net's
field passes the clamp on more than 5% of its voxels from the first reg
steps on, so the guard widens the clamp to 10 at the 10th reg step and
drops it at the 20th, inside the window.  Here those actions
(``settled_actions`` of the configuration) go through the experiment's own
``_apply_guard_action`` first: the checked first steps, the warm-up and
the window all run the rung a long run spends nearly all its steps on, and
the reference follows it (the configuration copy's ``max_disp`` points at
the rung; None warps unclamped).  On the unclamped rung every seg step
takes the soft branch, whatever its labels, so its kind says so.

One more number is read: ``reg_grad_median_gap``, the median leaf's gap of
the reg net's first gradient alone.  The joint ``grad_median_gap`` takes
the median over both networks' leaves, three quarters of them the seg
net's, so a reg net whose every leaf is off (LNCC's window sums without
their digits put it 6.9e8 times the reference's on an H100) still reads a
seg leaf's gap there.
"""
from __future__ import annotations

import numpy as np

from jobs import joint
from reference import steps as ref_steps


class Job(joint.Job):

    def build(self):
        super().build()
        for action in self.config["settled_actions"]:
            self.exp._apply_guard_action(dict(action))
        self.config = dict(self.config,
                           max_disp=self.exp.config["max_disp"])

    def gaps(self, losses, grads, change, ref, label="program") -> dict:
        out = super().gaps(losses, grads, change, ref, label)
        gaps = ref_steps.leaf_gaps(ref_steps.leaf_norms(grads["reg"]),
                                   ref_steps.leaf_norms(ref[1]["reg"]))
        out["reg_grad_median_gap"] = float(np.median(list(gaps.values())))
        return out

    def kind_of(self, index, names) -> str:
        kind = super().kind_of(index, names)
        if kind.startswith("joint_seg.") and self.config["max_disp"] is None:
            return "joint_seg.soft"
        return kind
