"""Deep synthetic QPNet — multi-level stress config.

An L-level chain (optionally W nodes wide per level) of strongly convex
tracking QPs: node (ℓ, i) owns a 2-vector and tracks an affine function of its
children's decisions plus a level-specific target.  Every level is a
Stackelberg layer, so the solver must propagate solution graphs through L−1
recursions — the piece-explosion / branch-partitioning stressor."""

from __future__ import annotations

import numpy as np

from ..frontend import QPNetBuilder, variables, _lift
from . import register


@register("deep_synthetic")
def setup(levels: int = 8, width: int = 1, seed: int = 0,
          box: float = 5.0, **kwargs):
    rng = np.random.default_rng(seed)
    xs = {}
    order = []
    for lv in range(levels):
        for wdx in range(width):
            v = variables(f"x_{lv}_{wdx}", 2)
            xs[(lv, wdx)] = v
            order.append(v)
    b = QPNetBuilder(*order)

    pids = {}
    targets = {}
    for lv in range(levels):
        for wdx in range(width):
            v = xs[(lv, wdx)]
            cid = b.add_constraint([v[0], v[1]],
                                   np.full(2, -box), np.full(2, box))
            t = rng.standard_normal(2)
            targets[(lv, wdx)] = t
            cost = _lift(0.0)
            d0 = v[0] - float(t[0])
            d1 = v[1] - float(t[1])
            cost = cost + d0 * d0 + d1 * d1
            if lv + 1 < levels:
                # couple to child level decisions (keeps levels interacting)
                for cw in range(width):
                    c = xs[(lv + 1, cw)]
                    cost = cost + 0.5 * ((v[0] - c[0]) * (v[0] - c[0])
                                         + (v[1] - c[1]) * (v[1] - c[1]))
            pids[(lv, wdx)] = b.add_qp(cost, [cid], v)

    edges = []
    for lv in range(levels - 1):
        for wdx in range(width):
            for cw in range(width):
                edges.append((pids[(lv, wdx)], pids[(lv + 1, cw)]))
    b.add_edges(edges)
    b.assign_constraint_groups()
    b.set_options(**kwargs)
    b.net.default_initialization = np.zeros(b.net.num_vars)
    b.net.problem_data["targets"] = targets
    return b.net
