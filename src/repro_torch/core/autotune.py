"""The paper's constrained-BO engine retargeted at the framework's own
layout knobs (the port of `repro.core.autotune`): mesh split, FSDP, remat
and the flash-attention block sizes of one (architecture x shape) cell.

The black box is the port's dry-run (`launch.dryrun`: one fake-world trace
of the step and its roofline for one H100 a device, tens of seconds a
point), the objective is the estimated step time (the EDP analogue:
minimize time at fixed hardware), known constraints (divisibility, axis
fit) are input constraints, and trace failures or a step that exceeds the
card's 80 GiB (`fits_hbm`) are unknown constraints handled by the GP
classifier.

`flash_bq` and `flash_bk` select nothing on the card: K3's tile is fixed at
64 x 64 and the kernel's `bq`/`bk` are signature-only, so two points that
differ only there trace the same step.  They stay in the space, with the
reference's values and features, so that the BO can be held against the
reference decision for decision.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.parallel.sharding import AxisRules

_MESH_SPLITS = [(64, 4), (32, 8), (16, 16), (8, 32), (4, 64)]
_BLOCKS = [256, 512, 1024, 2048]


@dataclasses.dataclass(frozen=True)
class TuneConfig:
    mesh_data: int = 16
    mesh_model: int = 16
    fsdp: bool = True
    remat: str = "block"          # "none" | "block"
    flash_bq: int = 1024
    flash_bk: int = 1024

    def rules(self) -> AxisRules:
        return AxisRules(fsdp="data" if self.fsdp else None)


@dataclasses.dataclass
class TuneSpace:
    """Constrained search space over TuneConfig for one (cfg, shape) cell."""

    cfg: ModelConfig
    shape: ShapeConfig
    total_chips: int = 256
    name: str = "autotune"
    device: str = "cuda"          # the dry-run's fake tensors' device type

    feature_dim: int = 7

    def sample(self, rng) -> TuneConfig:
        d, m = _MESH_SPLITS[rng.integers(len(_MESH_SPLITS))]
        return TuneConfig(
            mesh_data=d,
            mesh_model=m,
            fsdp=bool(rng.integers(2)),
            remat="block" if rng.integers(2) else "none",
            flash_bq=int(_BLOCKS[rng.integers(len(_BLOCKS))]),
            flash_bk=int(_BLOCKS[rng.integers(len(_BLOCKS))]),
        )

    def is_valid(self, t: TuneConfig) -> bool:
        # Known input constraints: mesh must multiply out; batch divisible by
        # the data axis; TP dims divisible by the model axis; flash blocks
        # cannot exceed the sequence.
        if t.mesh_data * t.mesh_model != self.total_chips:
            return False
        if self.shape.global_batch % t.mesh_data:
            return False
        for dim in (self.cfg.d_model, self.cfg.d_ff or self.cfg.d_model):
            if dim % t.mesh_model:
                return False
        if t.flash_bq > self.shape.seq_len or t.flash_bk > self.shape.seq_len:
            return False
        return True

    def features(self, t: TuneConfig) -> np.ndarray:
        return np.array([
            np.log2(t.mesh_data),
            np.log2(t.mesh_model),
            float(t.fsdp),
            1.0 if t.remat == "block" else 0.0,
            np.log2(t.flash_bq),
            np.log2(t.flash_bk),
            np.log2(t.mesh_data) - np.log2(max(t.mesh_model, 1)),
        ], np.float64)

    def evaluate(self, t: TuneConfig) -> tuple[float | None, bool]:
        """The dry-run of `t` in a fake world of `total_chips` ranks (one is
        started if none of that size runs).  Points that differ only in the
        flash blocks trace the same step on the card, so each (mesh, fsdp,
        remat) is traced once and its result reused."""
        key = (t.mesh_data, t.mesh_model, t.fsdp, t.remat)
        if key not in self._seen:
            self._seen[key] = self._evaluate(t)
        value, ok, rec = self._seen[key]
        if rec is not None:
            self.last_record = rec
        return value, ok

    def __post_init__(self):
        self._seen: dict = {}

    def _evaluate(self, t: TuneConfig):
        import contextlib

        import torch.distributed as dist

        from repro_torch.launch import dryrun as DR
        from repro_torch.launch.mesh import fake_world, make_mesh

        cfg = dataclasses.replace(
            self.cfg, remat=t.remat, flash_block_q=t.flash_bq,
            flash_block_k=t.flash_bk)
        world = (contextlib.nullcontext() if dist.is_initialized()
                 and dist.get_world_size() == self.total_chips
                 else fake_world(self.total_chips))
        try:
            with world:
                mesh = make_mesh((t.mesh_data, t.mesh_model),
                                 ("data", "model"), self.device)
                # as `dryrun.run_cell` does: the cells of a model with a
                # slow full-depth trace from depths 1 and 2
                lowered = (DR.extrapolated_costs(cfg, self.shape, mesh,
                                                 t.rules())
                           if DR.needs_extrapolation(cfg, self.shape) else
                           DR.lower_cell(cfg, self.shape, mesh, t.rules()))
                rec = DR.analyze(lowered, cfg, self.shape, mesh, t.rules())
        except Exception:
            return None, False, None   # unknown constraint: trace failure
        if not rec["memory"]["fits_hbm"]:
            return None, False, None   # unknown constraint: exceeds HBM
        step = rec["roofline"]["step_time_s"]
        return -float(np.log10(step)), True, rec


def autotune(cfg: ModelConfig, shape: ShapeConfig, n_trials: int = 12,
             n_warmup: int = 4, pool_size: int = 32, seed: int = 0,
             device: str = "cuda"):
    """Run constrained BO over the tune space; returns (best TuneConfig,
    BOResult).  The GP fits on `device` (the card by default), and the
    dry-run traces fake tensors of its type."""
    from repro_torch.core.bo import bo_maximize
    from repro_torch.device import resolve_device

    space = TuneSpace(cfg, shape, device=resolve_device(device).type)
    result = bo_maximize(space, n_trials=n_trials, n_warmup=n_warmup,
                         pool_size=pool_size, acquisition="lcb", lam=1.0,
                         surrogate="gp_linear", noisy=False, seed=seed,
                         device=device)
    return result.best_point, result


def main(argv=None) -> int:
    """`python -m repro_torch.core.autotune --arch A --shape S`: the BO over
    one cell's tune space (GP on `--device`, the card by default; the
    dry-run's fake tensors of the same type).  Prints every evaluated point
    and the best one with its estimated step time; `--json` prints the
    result as one JSON line last."""
    import argparse
    import json
    import time

    from repro_torch.configs.base import SHAPES, get_config

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--trials", type=int, default=12)
    ap.add_argument("--warmup", type=int, default=4)
    ap.add_argument("--pool", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    best, result = autotune(get_config(args.arch), SHAPES[args.shape],
                            n_trials=args.trials, n_warmup=args.warmup,
                            pool_size=args.pool, seed=args.seed,
                            device=args.device)
    wall = time.perf_counter() - t0
    for p, v in zip(result.points, result.values):
        print(f"trial {p} -> "
              + (f"step {10 ** -v:.4e} s" if np.isfinite(v) else "infeasible"))
    step = 10 ** -result.best_value if best is not None else None
    print(f"best {best} step {step} s ({wall:.0f}s, "
          f"{result.n_infeasible} infeasible)")
    if args.json:
        print(json.dumps({
            "arch": args.arch, "shape": args.shape, "trials": args.trials,
            "warmup": args.warmup, "device": args.device,
            "best": None if best is None else dataclasses.asdict(best),
            "best_step_time_s": step, "wall_s": wall,
            "n_infeasible": result.n_infeasible,
            "points": [dataclasses.asdict(p) for p in result.points],
            "step_time_s": [10 ** -v if np.isfinite(v) else None
                            for v in result.values]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
