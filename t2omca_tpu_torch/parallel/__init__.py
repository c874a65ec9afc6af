"""Data parallelism over ``torch.distributed``, Sebulba's decoupled
actor/learner sets, a population over either, and sequence parallelism
(port of ``t2omca_tpu/parallel``: ``distributed.py``, ``mesh.py``'s
``DataParallel``, ``partition_devices`` and ``population_shardings``,
``sebulba.py``, ``ring_attention.py`` and ``sp_mixer.py``: the ring and
Ulysses attention and the sequence-parallel mixer over placements, which
no driver path reaches, as in JAX)."""

from .distributed import (announce_shutdown, launch_ranks,
                          maybe_initialize_distributed,
                          negotiate_stop_step, peer_shutdown_requested)
from .mesh import DataParallel, RankComm
from .ring_attention import ring_attention, sp_placements, ulysses_attention
from .sp_mixer import mixer_apply_sp

__all__ = ["DataParallel", "RankComm", "announce_shutdown", "launch_ranks",
           "maybe_initialize_distributed", "mixer_apply_sp",
           "negotiate_stop_step", "peer_shutdown_requested",
           "ring_attention", "sp_placements", "ulysses_attention"]
