"""Software-mapping search space for one (hardware, layer) pair (paper §4.3).

All constraints are *known* here (hardware and layer are fixed), so the sampler
enforces them as input constraints; the evaluator is deterministic, so the GP
uses no noise kernel.  Features follow Fig. 13 plus order-sensitive log trip
counts, which give the linear kernel direct visibility into the reuse structure.

The space implements the BO loop's batched evaluation protocol on top of a
selectable engine:

  backend="torch"  `repro_torch.timeloop.batch_torch` -- the device engine
                   (default) with the hand-written CUDA kernel K1 on the card;
                   additionally exposes `features_batch_device` so the BO loop
                   can keep the GP posterior + acquisition scoring
                   device-resident
  backend="numpy"  `repro_torch.timeloop.batch` -- vectorized NumPy on the host

`device` says where the torch engine runs ("cuda" unless the caller asks for
"cpu").  Candidate pools are sampled host-side with either backend -- the
constrained rejection sampler is branchy NumPy on the explicit `Generator`s the
search threads through; only featurization/evaluation/scoring move to the
device.  Set `batched=False` to force the scalar reference path.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch import trace
from repro_torch.core.cache import SlotCache
from repro_torch.core.config import BACKENDS, validate_choice
from repro_torch.device import resolve_device
from repro_torch.timeloop import batch as tlb
from repro_torch.timeloop.arch import HardwareConfig
from repro_torch.timeloop.mapping import (
    Mapping,
    constrained_random_mapping,
    gb_tiles,
    lb_tiles,
    mapping_is_valid,
)
from repro_torch.timeloop.model import _level_trips, evaluate
from repro_torch.timeloop.workloads import DIMS, RELEVANCE, ConvLayer

FEATURE_NAMES = (
    "input_buffer_usage",
    "weight_buffer_usage",
    "output_buffer_usage",
    "global_buffer_usage",
    "parallelism_ratio_x",
    "parallelism_ratio_y",
    "log_trips_W_gb",
    "log_trips_I_gb",
    "log_trips_O_gb",
    "log_trips_W_dram",
    "log_trips_I_dram",
    "log_trips_O_dram",
    "log_used_pes",
    "log_macs_per_pe",
)


@dataclasses.dataclass
class SoftwareSpace:
    hw: HardwareConfig
    layer: ConvLayer
    name: str = "software"
    batched: bool = True  # expose the batched protocol to the BO loop
    backend: str = "torch"  # "torch" | "numpy"
    device: str = "cuda"    # where the torch engine runs

    def __post_init__(self) -> None:
        validate_choice("backend", self.backend, BACKENDS)
        if self.backend == "torch":
            resolve_device(self.device)
        # One fused device program computes validity+EDP+features together, so
        # features_batch / evaluate_batch / features_batch_device on the same
        # pool object must share a single dispatch (the BO warmup calls two of
        # them back to back).  One slot: the forward dict holds whole-pool
        # device arrays, so a deeper cache would double peak device memory.
        self._fwd_cache = SlotCache("sw_fwd", capacity=1)
        # NumPy twin of the memo: pool-identity cache for the packed feature
        # matrix, so repeat featurizations of the same pool object (frozen
        # refit windows, outer-loop hooks) are free on either backend.
        self._np_feat_cache = SlotCache("sw_feat", capacity=2)

    def _forward_torch(self, pool) -> dict:
        out = self._fwd_cache.get(pool)
        if out is None:
            # The device engine loads at its first use, so a process that
            # only holds configs (an unpickled search spec) never imports it.
            from repro_torch.timeloop import batch_torch as ttlb

            out = ttlb.forward_device(self.hw, pool, self.layer,
                                      device=self.device)
            self._fwd_cache.put(pool, out)
        return out

    @property
    def feature_dim(self) -> int:
        return len(FEATURE_NAMES)

    @property
    def supports_batch(self) -> bool:
        return self.batched

    @property
    def supports_device(self) -> bool:
        """Whether `features_batch_device` returns device-resident arrays the
        BO loop can score without a host round-trip."""
        return self.batched and self.backend == "torch"

    def sample(self, rng) -> Mapping:
        return constrained_random_mapping(rng, self.hw, self.layer)

    def is_valid(self, m: Mapping) -> bool:
        return mapping_is_valid(m, self.hw, self.layer)[0]

    def features(self, m: Mapping) -> np.ndarray:
        lb = lb_tiles(m, self.layer)
        gb = gb_tiles(m, self.layer)
        f_gb = {d: m.f("gb", d) for d in DIMS}
        f_dram = {d: m.f("dram", d) for d in DIMS}
        trips = []
        for lvl_factors, order in ((f_gb, m.order_gb), (f_dram, m.order_dram)):
            for t in ("W", "I", "O"):
                trips.append(np.log1p(_level_trips(order, lvl_factors, RELEVANCE[t])))
        used = m.used_pes
        return np.array(
            [
                lb["I"] / self.hw.lb_input,
                lb["W"] / self.hw.lb_weight,
                lb["O"] / self.hw.lb_output,
                (gb["I"] + gb["W"] + gb["O"]) / self.hw.gb_entries,
                m.spatial_x / self.hw.pe_mesh_x,
                m.spatial_y / self.hw.pe_mesh_y,
                *trips[:3],
                *trips[3:],
                np.log1p(used),
                np.log1p(self.layer.macs / used),
            ],
            dtype=np.float64,
        )

    def evaluate(self, m: Mapping) -> tuple[float | None, bool]:
        """Returns (utility, feasible); utility = -log10(EDP), maximized."""
        ev = evaluate(self.hw, m, self.layer)
        if not ev.valid:
            return None, False
        return -float(np.log10(ev.edp)), True

    # --- batched evaluation protocol (batch / batch_torch) ----------------------

    def sample_pool(self, rng, n: int) -> tlb.MappingBatch | None:
        """n input-valid candidates drawn in vectorized rounds (None if the
        space looks empirically empty)."""
        return tlb.sample_valid_pool(rng, self.hw, self.layer, n)

    def features_batch(self, pool: tlb.MappingBatch) -> np.ndarray:
        if self.backend == "torch":
            return trace.host(self._forward_torch(pool)["features"])
        feats = self._np_feat_cache.get(pool)
        if feats is None:
            feats = tlb.features_batch(pool, self.hw, self.layer)
            self._np_feat_cache.put(pool, feats)
        return feats

    def evaluate_batch(self, pool: tlb.MappingBatch) -> tuple[np.ndarray, np.ndarray]:
        """Returns (utility (B,), feasible (B,)); utility is -log10(EDP) with
        -inf on infeasible rows."""
        if self.backend == "torch":
            out = self._forward_torch(pool)
            return trace.host(out["utility"]), trace.host(out["valid"])
        ev = tlb.evaluate_batch(self.hw, pool, self.layer)
        feasible = ev["valid"]
        with np.errstate(divide="ignore", invalid="ignore"):
            utility = np.where(feasible, -np.log10(ev["edp"]), -np.inf)
        return utility, feasible

    def edp_batch(self, pool: tlb.MappingBatch) -> tuple[np.ndarray, np.ndarray]:
        """Returns (EDP (B,), valid (B,)) on the host, from the same forward
        as `evaluate_batch` (inf EDP on invalid rows)."""
        if self.backend == "torch":
            out = self._forward_torch(pool)
            return trace.host(out["edp"]), trace.host(out["valid"])
        ev = tlb.evaluate_batch(self.hw, pool, self.layer)
        return ev["edp"], ev["valid"]

    def features_batch_device(self, pool: tlb.MappingBatch):
        """(B, 14) features as a device-resident tensor (torch backend only)."""
        if self.backend != "torch":
            raise ValueError("device features require backend='torch'")
        return self._forward_torch(pool)["features"]


def fanout_spaces(items, *, batched: bool = True, backend: str = "torch",
                  device: str = "cuda",
                  pad_to: int | None = None) -> list[SoftwareSpace]:
    """Pack (hardware, layer) work items into the `SoftwareSpace` runs of one
    stacked multi-run fan-out (`bo_maximize_many` stacks them through
    `LayerStackSpace`; the hardware vector rides per row).

    `pad_to`: on the torch backend the speculative outer loop's stack is
    padded to a whole number of probes with copies of run 0, so the per-round
    device program keeps one of at most `spec_k` shapes across trials as
    cached probes drop out (the reference padded for its jit cache; the port
    keeps the same runs so both search the same stacks).  Padded runs are
    real but redundant searches; callers slice results back to `len(items)`.
    On NumPy every run costs real host work, so no padding is applied
    there."""
    spaces = [SoftwareSpace(hw, layer, batched=batched, backend=backend,
                            device=device)
              for hw, layer in items]
    if (pad_to is not None and spaces and spaces[0].backend == "torch"
            and len(spaces) < pad_to):
        spaces += [dataclasses.replace(spaces[0])
                   for _ in range(pad_to - len(spaces))]
    return spaces


@dataclasses.dataclass
class LayerStackSpace:
    """L `SoftwareSpace` runs advanced as one stacked batch -- the packing
    layer of the layer-batched nested search (all runs share one hardware
    probe) and of the probe-fanout warmup (runs span H hardware probes; the
    hardware vector rides per row exactly like the layer vector).

    The multi-run BO engine (`repro_torch.core.bo.bo_maximize_many`) hands this a
    list of per-run candidate pools (one `MappingBatch` per run) and gets
    back (L, B)-shaped results:

      * `backend="torch"`: all pools are packed into a single (L*B, 5, 6)
        batch and evaluated by ONE fused device program per BO round
        (`batch_torch.forward_device_stacked`, hardware + layer vectors per
        row; one launch of kernel K1), with `features_stacked_device` keeping
        the feature matrix device-resident for the fused GP-acquisition
        scoring chain;
      * `backend="numpy"`: per-space vectorized NumPy calls, stacked host-side
        (no fused program, but the stacked-GP surrogate path still applies).

    Per-row numerics are identical to the per-run `SoftwareSpace` calls, so
    a multi-run search reproduces L sequential `bo_maximize` runs.
    """

    spaces: tuple

    def __post_init__(self) -> None:
        if not self.spaces:
            raise ValueError("empty stack")
        s0 = self.spaces[0]
        if not all(s.backend == s0.backend and s.device == s0.device
                   for s in self.spaces):
            raise ValueError("stacked spaces must share backend and device")

    @classmethod
    def maybe(cls, spaces) -> "LayerStackSpace | None":
        """Build a stack when the runs are stackable: all `SoftwareSpace`s with
        the batched protocol, one backend, one device (hardware configs
        may differ per run -- the probe-fanout case).  Returns None otherwise
        (the BO engine then falls back to lockstep per-space calls)."""
        spaces = tuple(spaces)
        if not spaces or not all(isinstance(s, SoftwareSpace) for s in spaces):
            return None
        if not all(s.supports_batch for s in spaces):
            return None
        if not all(s.backend == spaces[0].backend
                   and s.device == spaces[0].device
                   for s in spaces):
            return None
        return cls(spaces)

    @property
    def hws(self) -> list[HardwareConfig]:
        return [s.hw for s in self.spaces]

    @property
    def backend(self) -> str:
        return self.spaces[0].backend

    @property
    def supports_device(self) -> bool:
        return self.backend == "torch"

    @property
    def n_runs(self) -> int:
        return len(self.spaces)

    def placeholder_pool(self, n: int) -> tlb.MappingBatch:
        """All-ones pool of length n: benign rows (finite arithmetic, invalid
        under the factorization check) used to keep the stacked program's
        (L, B) shape fixed when some runs sit a round out (no surrogate yet,
        or stopped early), so the device rows of every run keep their
        places."""
        return tlb.MappingBatch(
            factors=np.ones((n, 5, 6), np.int64),
            order_lb=np.tile(np.arange(6, dtype=np.int64), (n, 1)),
            order_gb=np.tile(np.arange(6, dtype=np.int64), (n, 1)),
            order_dram=np.tile(np.arange(6, dtype=np.int64), (n, 1)),
        )

    def _forward_stacked_torch(self, pools) -> dict:
        from repro_torch.timeloop import batch_torch as ttlb

        return ttlb.forward_device_stacked(
            self.hws, pools, [s.layer for s in self.spaces],
            device=self.spaces[0].device)

    def forward_stacked(self, pools, runs=None) -> dict[str, np.ndarray]:
        """Host-side stacked forward over per-run pools (all of equal length):
        dict of `features` (L, B, 14), `utility` (L, B), `valid` (L, B).

        `runs` restricts the NumPy path to the listed run indices (other rows
        stay zero) -- rounds where only a subset of runs participates; the
        torch path always evaluates the full fixed-(L, B) fused program
        instead (one launch for every run)."""
        B = len(pools[0])
        if not all(len(p) == B for p in pools):
            raise ValueError("stacked pools must have equal lengths")
        if self.backend == "torch":
            out = self._forward_stacked_torch(pools)
            return {k: trace.host(out[k])
                    for k in ("features", "utility", "valid")}
        L = self.n_runs
        feats = np.zeros((L, B, self.spaces[0].feature_dim))
        utility = np.full((L, B), -np.inf)
        valid = np.zeros((L, B), dtype=bool)
        for k in range(L) if runs is None else runs:
            feats[k] = self.spaces[k].features_batch(pools[k])
            utility[k], valid[k] = self.spaces[k].evaluate_batch(pools[k])
        return {"features": feats, "utility": utility, "valid": valid}

    def features_stacked(self, pools, runs=None) -> np.ndarray:
        """(L, B, 14) host feature tensor only -- the per-trial scoring input.
        On NumPy this skips the EDP evaluation entirely (the sequential BO
        trial only featurizes its pool; the winner is evaluated scalar)."""
        B = len(pools[0])
        if not all(len(p) == B for p in pools):
            raise ValueError("stacked pools must have equal lengths")
        if self.backend == "torch":
            return trace.host(
                self._forward_stacked_torch(pools)["features"])
        feats = np.zeros((self.n_runs, B, self.spaces[0].feature_dim))
        for k in range(self.n_runs) if runs is None else runs:
            feats[k] = self.spaces[k].features_batch(pools[k])
        return feats

    def features_stacked_device(self, pools):
        """(L, B, 14) device-resident features for the fused multi-run GP
        scoring chain (torch backend only)."""
        if not self.supports_device:
            raise ValueError("device features require backend='torch'")
        return self._forward_stacked_torch(pools)["features"]
