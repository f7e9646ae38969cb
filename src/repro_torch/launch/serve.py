"""Serving entry point: batched prefill + greedy decode with a request queue
(the port of `repro.launch.serve`).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \\
        --requests 16 --batch 8 --prompt-len 1024 --gen-len 64

Runs on the card (`--device cuda`, the default; it raises without CUDA) or
the host (`--device cpu`).  Weights are random, from `--seed` through a
`torch.Generator`; prompts come from a NumPy generator on the same seed, as
in the reference.  The call sequence is the reference's, on purpose: each
batch is prefilled on the padded prompt (result discarded) and again on
S_max (prompt + gen rounded up to 64); the first token is the argmax of the
last padded position's logits over the padded vocabulary, later tokens the
argmax over the real vocabulary.  The KV cache follows the config's dtype
(bf16, f32 or int8).  Every token-in/token-out arch is served: dense, MoE,
hybrid (RG-LRU with local attention) and xLSTM; the encoder-decoder and the
embedding-input archs are refused with a message that points at their
model API (`prefill` / `decode_step` on the model itself).
"""

from __future__ import annotations

import argparse
import dataclasses
import statistics
import time

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.models.model import build_model


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray      # (prompt_len,)
    gen_len: int
    out_tokens: list = dataclasses.field(default_factory=list)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def seq_lens(args) -> tuple[int, int]:
    """(P, S_max): the prompt and the prompt plus generation, each rounded up
    to the attention kernel's 64-row tiles."""
    def up(n):
        return ((n + 63) // 64) * 64
    return up(args.prompt_len), up(args.prompt_len + args.gen_len)


def make_requests(cfg: ModelConfig, args) -> list[Request]:
    """The requests' prompts, drawn from a NumPy generator on `args.seed`."""
    rng = np.random.default_rng(args.seed)
    return [Request(i, rng.integers(0, cfg.vocab_size, args.prompt_len),
                    args.gen_len) for i in range(args.requests)]


def pad_tokens(prompts: np.ndarray, length: int) -> np.ndarray:
    """Right-pad (B, prompt_len) prompts with token 0 to `length`."""
    toks = np.zeros((prompts.shape[0], length), np.int64)
    toks[:, :prompts.shape[1]] = prompts
    return toks


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(cfg: ModelConfig, args: argparse.Namespace,
          params: dict[str, torch.Tensor] | None = None,
          generator: torch.Generator | None = None):
    """Serve `args.requests` requests of `cfg`.  `params` (a state dict of
    f32 tensors) replaces the random weights; `generator` replaces the CPU
    generator on `args.seed` that draws them (one on the card draws a model
    of tens of GB there in seconds).  Returns (finished requests, stats:
    wall seconds, tok/s, prefill and decode-step milliseconds)."""
    if cfg.family == "encdec" or cfg.input_mode == "embeddings":
        raise SystemExit("serve.py demo drives token-in/token-out archs; "
                         "drive the stub-frontend archs through "
                         "build_model(cfg).prefill and .decode_step")
    device = resolve_device(args.device)
    model = build_model(cfg, device)
    if params is not None:
        model.load_params(params)
    else:
        model.init(generator or torch.Generator().manual_seed(args.seed))
    B = args.batch
    P, S_max = seq_lens(args)
    pending = make_requests(cfg, args)
    done: list[Request] = []
    prefill_prompt_s, prefill_s, decode_s = [], [], 0.0

    def timed_prefill(toks, into):
        _sync(device)
        t = time.perf_counter()
        out = model.prefill({"tokens": torch.from_numpy(toks)})
        _sync(device)
        into.append(time.perf_counter() - t)
        return out

    _sync(device)
    t0 = time.perf_counter()
    decode_steps = 0
    while pending:
        batch_reqs = pending[:B]
        pending = pending[B:]
        while len(batch_reqs) < B:   # pad the batch with a dummy copy
            batch_reqs.append(Request(-1, batch_reqs[0].prompt,
                                      batch_reqs[0].gen_len))
        prompts = np.stack([r.prompt for r in batch_reqs])
        # discarded, as in the reference
        timed_prefill(pad_tokens(prompts, P), prefill_prompt_s)
        logits, cache = timed_prefill(pad_tokens(prompts, S_max), prefill_s)
        next_tok = torch.argmax(logits[:, -1], dim=-1)
        pos = args.prompt_len
        t = time.perf_counter()
        for _ in range(args.gen_len):
            for r, tok in zip(batch_reqs, next_tok.tolist()):
                r.out_tokens.append(int(tok))
            logits, cache = model.decode_step(cache, {"tokens": next_tok[:, None]},
                                              pos)
            next_tok = torch.argmax(logits[:, 0, :cfg.vocab_size], dim=-1)
            pos += 1
            decode_steps += 1
        _sync(device)
        decode_s += time.perf_counter() - t
        done.extend(r for r in batch_reqs if r.rid >= 0)
    dt = time.perf_counter() - t0
    stats = {
        "device": str(device), "requests": len(done),
        "decode_steps": decode_steps, "wall_s": dt,
        "tok_s": decode_steps * B / dt if dt > 0 else 0.0,
        "prefill_ms": 1e3 * statistics.mean(prefill_s) if prefill_s else None,
        "prefill_prompt_ms": (1e3 * statistics.mean(prefill_prompt_s)
                              if prefill_prompt_s else None),
        "prefill_calls": len(prefill_s) + len(prefill_prompt_s),
        "decode_step_ms": 1e3 * decode_s / decode_steps if decode_steps else None,
        "S_max": S_max}
    return done, stats


def main(argv=None, *, config: ModelConfig | None = None,
         params: dict[str, torch.Tensor] | None = None):
    """Parse `argv`, serve, print a summary and return the finished
    requests.  `config` replaces the --arch config and `params` the random
    weights (the tests hand over the reference's)."""
    args = parse_args(argv)
    cfg = config or (get_smoke_config(args.arch) if args.smoke
                     else get_config(args.arch))
    done, stats = serve(cfg, args, params)
    print(f"served {stats['requests']} requests, {stats['decode_steps']} "
          f"decode steps, {stats['wall_s']:.1f}s, {stats['tok_s']:.1f} tok/s "
          f"(batched) on {stats['device']}")
    for r in done[:3]:
        print(f"  req {r.rid}: first tokens {r.out_tokens[:8]}")
    return done


if __name__ == "__main__":
    main()
