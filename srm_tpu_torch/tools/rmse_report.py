"""Join two matched-RMSE trajectories into the speedup table.

    python -m srm_tpu_torch.tools.rmse_report <srm_traj.json> <tf_traj.json>

A copy of the repo's pure-Python ``tools/rmse_report.py``, kept in the
port. For each evaluation point (wall_s, rmse) of the second trajectory
(the TF reference's), it finds the earliest point of the first (a results
JSON of ``rmse_experiment train``) whose RMSE is at or below it; the ratio
of their wall clocks is the speedup at matched pressure RMSE. Prints one
JSON object.
"""

from __future__ import annotations

import json
import sys


def crossings(srm, tf):
    """For each TF eval point, the earliest srm point at or below its RMSE."""
    rows = []
    for pt in tf["trajectory"]:
        target = pt["rmse_psia"]
        hit = next((s for s in srm["trajectory"] if s["rmse_psia"] <= target), None)
        rows.append({
            "rmse_level_psia": target,
            "tf_wall_s": pt["wall_s"], "tf_steps": pt["step"],
            "srm_wall_s": hit["wall_s"] if hit else None,
            "srm_steps": hit["steps"] if hit else None,
            "speedup": (round(pt["wall_s"] / hit["wall_s"], 1)
                        if hit and hit["wall_s"] > 0 else None),
        })
    return rows


def report(srm, tf) -> dict:
    rows = crossings(srm, tf)
    return {
        "predict_pi_rmse_psia": srm["rmse_predict_pi"],
        "tf_best_rmse_psia": min(p["rmse_psia"] for p in tf["trajectory"]),
        "srm_best_rmse_psia": min(p["rmse_psia"] for p in srm["trajectory"]),
        "matched_rmse_rows": rows,
        "speedups_at_tf_levels": [r["speedup"] for r in rows],
    }


def main(argv=None):
    argv = argv or sys.argv[1:]
    with open(argv[0]) as f:
        srm = json.load(f)
    with open(argv[1]) as f:
        tf = json.load(f)
    out = report(srm, tf)
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
