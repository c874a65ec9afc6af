"""Single-env episode runner — evaluation, animation, benchmark export (port
of ``t2omca_tpu/runners/episode_runner.py``).

The episode runs through the same rollout as ``ParallelRunner`` with
``B = 1``, and the *same rollout* emits the visualization trajectory
(AGV positions, serving MECs, ACKs, step info; ``capture=True``), so the
exported trajectory is exactly the episode whose batch and stats are
returned.

Exports: ``save_replay`` (npz of the trajectory arrays), ``benchmark_csv``
(one row an episode, the JAX columns; written with the standard
library's ``csv`` module, so it needs no pandas) and ``save_animation``
(a gif through matplotlib; returns None where matplotlib is absent, as
in the JAX runner).
"""

from __future__ import annotations

import csv
import dataclasses
import os
from typing import Dict, List, Optional

import numpy as np

from ..config import TrainConfig
from ..controllers.basic_mac import BasicMAC
from ..envs.mec_offload import MultiAgvOffloadingEnv
from .parallel_runner import ParallelRunner, RunnerState

#: benchmark.csv's columns, in the JAX runner's order
BENCHMARK_COLUMNS = ("episode", "return", "delay_reward", "overtime_penalty",
                     "channel_utilization_rate", "conflict_ratio",
                     "task_completion_rate", "task_completion_delay",
                     "deadline_miss_rate")


@dataclasses.dataclass(frozen=True)
class EpisodeRunner:
    """Batch-1 runner reusing the ParallelRunner rollout, plus viz capture."""

    env: MultiAgvOffloadingEnv
    mac: BasicMAC
    cfg: TrainConfig

    def __post_init__(self):
        object.__setattr__(
            self, "_inner",
            ParallelRunner(self.env, self.mac,
                           self.cfg.replace(batch_size_run=1)))

    def init_state(self, key) -> RunnerState:
        return self._inner.init_state(key)

    # ------------------------------------------------------------------ run

    def run(self, params, rs: RunnerState, test_mode: bool = True,
            capture_trajectory: bool = False):
        """→ (rs', batch, stats[, trajectory]). ``trajectory`` is a host-side
        dict of per-step arrays for rendering/benchmark export, emitted by
        the same rollout that produced ``batch``."""
        if not capture_trajectory:
            return self._inner.run(params, rs, test_mode=test_mode)
        rs2, batch, stats, viz = self._inner.run(
            params, rs, test_mode=test_mode, capture=True)
        return rs2, batch, stats, self._to_host(viz, rs2)

    def _to_host(self, viz, rs: RunnerState) -> Dict[str, np.ndarray]:
        """Device ``(T, B=1, ...)`` viz → host dict of ``(T, ...)``."""
        info = viz["info"]
        lane = lambda x: x[:, 0].cpu().numpy()
        return {
            "pos": lane(viz["pos"]),
            "mec_index": lane(viz["mec_index"]),
            "actions": lane(viz["actions"]),
            "acks": lane(viz["acks"]),
            "reward": lane(viz["reward"]),
            "delay_reward": lane(info.delay_reward),
            "overtime_penalty": lane(info.overtime_penalty),
            "channel_utilization_rate": lane(info.channel_utilization_rate),
            "conflict_ratio": lane(info.conflict_ratio),
            "task_completion_rate": lane(info.task_completion_rate),
            "task_completion_delay": lane(info.task_completion_delay),
            "deadline_miss_rate": lane(info.deadline_miss_rate),
            "mec_positions": self.env.mec_positions(rs.env_params)[0]
                                 .cpu().numpy(),
            "radius": np.asarray(self.env.cfg.communication_range_m),
        }

    # ------------------------------------------------------------------ export

    @staticmethod
    def save_replay(traj: Dict[str, np.ndarray], path: str) -> str:
        """Replay = the recorded trajectory arrays (npz)."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.savez_compressed(path, **{k: v for k, v in traj.items()})
        return path

    @staticmethod
    def save_animation(traj: Dict[str, np.ndarray], path: str,
                       fps: int = 10) -> Optional[str]:
        """Render the MEC deployment + AGV trajectory to a gif; None where
        matplotlib is absent."""
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
            from matplotlib import animation
        except Exception:   # matplotlib absent → gracefully skip (env gate)
            return None

        mecs, r = traj["mec_positions"], float(traj["radius"])
        fig, ax = plt.subplots(figsize=(8, 4))
        for (x, y) in mecs:
            ax.add_patch(plt.Circle((x, y), r, fill=False, ls="--"))
            ax.plot([x], [y], marker="s", ms=8)
        scat = ax.scatter(traj["pos"][0, :, 0], traj["pos"][0, :, 1])
        ax.set_xlim(-r, mecs[:, 0].max() + r)
        ax.set_ylim(-r, 3 * r)
        ax.set_aspect("equal")

        def update(i):
            scat.set_offsets(traj["pos"][i])
            colors = np.where(traj["acks"][i] == -1, "red",
                              np.where(traj["acks"][i] == 1, "green", "gray"))
            scat.set_color(colors)
            ax.set_title(f"slot {i}  reward {traj['reward'][i]:.1f}")
            return (scat,)

        anim = animation.FuncAnimation(
            fig, update, frames=len(traj["pos"]), blit=False)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        anim.save(path, writer=animation.PillowWriter(fps=fps))
        plt.close(fig)
        return path

    @staticmethod
    def benchmark_csv(trajs: List[Dict[str, np.ndarray]], path: str) -> str:
        """Benchmark-mode export: one row an episode, the JAX runner's
        columns (the reference wrote these through pandas; the standard
        ``csv`` module writes the same table)."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(BENCHMARK_COLUMNS)
            for ep, traj in enumerate(trajs):
                w.writerow([
                    ep,
                    float(traj["reward"].sum()),
                    float(traj["delay_reward"].sum()),
                    float(traj["overtime_penalty"].sum()),
                    float(traj["channel_utilization_rate"].mean()),
                    float(traj["conflict_ratio"].mean()),
                    float(traj["task_completion_rate"][-1]),
                    float(traj["task_completion_delay"][-1]),
                    float(traj["deadline_miss_rate"][-1])])
        return path
