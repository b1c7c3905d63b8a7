"""The comparison of a configuration of primitive obstacles, for a
configuration file that names no ``reference`` (``panda_analytic``,
``panda_voxel``): ``check.py``'s, with the analytic or the voxel field as
the configuration runs it.  The harness's docstring gives the interface."""

from __future__ import annotations

from . import check

CHECKS = ("fk_gap_m", "sdf_pot_gap", "sdf_grad_gap", "collide_excess",
          "obstacle_gap", "step_gap", "goal_pose_err", "goal_pot_gap",
          "goal_invalid", "final_gap", "flag_flips")


def check_request(rec: dict, conf: dict, cfg, out: check.Readings):
    check.check_request(rec, bool(cfg.sdf_analytic), out=out)


def check_control(rec: dict, conf: dict, cfg) -> check.Readings:
    return check.check_control(rec, bool(cfg.sdf_analytic))
