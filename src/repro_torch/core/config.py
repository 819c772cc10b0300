"""Configuration for the Dynamic Prober (paper §4).

A field-for-field copy of ``repro.core.config.ProberConfig`` (same names,
same defaults), so configurations compare equal across the two packages.
``a = ln(1/delta)`` is the Chernoff confidence constant from paper §4.5.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class ProberConfig:
    """Static prober settings.

    The port honours the LSH, probing, sampling and PQ/ADC fields
    (``use_pq`` and every ``pq_*`` field) as the reference does;
    ``table_max_dist`` is the neighbor table's M (``core/neighbors.py``)
    and ``ingest_chunk`` the coalescer's ingest chunk. ``lane_tile`` and ``use_kernels`` are
    ignored: all active lanes of a batch run as one batch on the GPU, and on
    CUDA tensors the kernels always run (CPU tensors take the plain
    versions in ``kernels/ref.py``). ``lane_block`` is the number of slab
    steps between two compactions of the active lanes; ``lane_block=0``
    compacts after every step, where the reference runs its monolithic
    loop. Results are bit-identical for every value, in both packages.
    """
    # --- LSH index (paper §2.2, §4.2) ---
    n_tables: int = 2          # L hash tables
    n_funcs: int = 10          # K hash functions per table
    n_regions: int = 4         # target distinct values per function (Ex. 4.1)
    # --- adaptive probing (paper §4.3/4.4, Alg. 1) ---
    max_visit: int = 8192      # maxVisit: total candidate budget across rings
    ring_budget: int = 4096    # R_max: max candidates gathered per ring
    central_budget: int = 4096 # cap for the exact central-bucket pass (Alg. 3)
    # --- progressive sampling (paper §4.5, Alg. 2) ---
    s1: float = 0.05           # initial sampling rate
    s_max: float = 1.0         # maximum sampling rate
    eps: float = 0.01          # error-bound parameter epsilon
    delta: float = 1e-3        # failure probability (a = ln(1/delta))
    chunk: int = 256           # candidates evaluated per slab step
    schedule_checks: bool = True   # bound checks only at s_{i+1}=2 s_i points
    # --- PQ / ADC (paper §4.6, Alg. 4/5/8) ---
    use_pq: bool = False
    pq_m: int = 8
    pq_kc: int = 16
    pq_iters: int = 8
    pq_int8_lut: bool = False
    pq_pack4: bool = False
    pq_banded: bool = False
    pq_exact_rings: int = 2
    pq_exact_central: bool = True
    # --- probe scheduling ---
    lane_block: int = 4        # slab steps between lane compactions; 0
                               # compacts after every step (see above)
    lane_tile: int = 16        # ignored by the port (see class docstring)
    # --- neighbor lookup (paper §4.7, Alg. 6) ---
    table_max_dist: int = 6
    # --- serving ingest (paper §5) ---
    ingest_chunk: int = 256
    # --- kernels ---
    use_kernels: bool = False  # ignored by the port (see class docstring)

    @property
    def a_const(self) -> float:
        return math.log(1.0 / self.delta)

    def replace(self, **kw) -> "ProberConfig":
        return dataclasses.replace(self, **kw)
