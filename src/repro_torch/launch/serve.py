"""Serving launcher: batched prefill + decode loop (counterpart of
`repro.launch.serve`).

A request batch is prefilled in one pass (on the card the sequence mixer
runs its kernel: flash attention for olmo-1b, the rwkv6 wkv scan for
rwkv6-7b, the Mamba2 SSD scan and flash attention for zamba2-1.2b), then
decoded one token per step for the whole batch, greedy or with temperature
sampling (an rwkv6 or Mamba2 decode step is a one-token scan from the
carried state, through the same kernel). `serve` is the function the CLI, the
tests and chip_smoke.py all drive; it reports each kernel's launches.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b \
      --requests 8 --prompt-len 1024 --max-new 32          # on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \
      --requests 8 --prompt-len 1024 --max-new 32          # on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \
      --requests 8 --prompt-len 1024 --max-new 32          # on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \
      --requests 8 --prompt-len 1024 --max-new 32          # on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b --reduced \
      --device cpu --requests 2 --prompt-len 12 --max-new 4

Every arch of `configs.ARCH_IDS` serves: olmo-1b, gemma-2b, qwen3-8b,
qwen2.5-32b, mixtral-8x7b (windowed), deepseek-v2-lite-16b (MLA: the absorbed
decode runs in plain torch, as the reference's), phi-3-vision-4.2b and
whisper-tiny (encoder, decoder self- and cross-attention) through flash
attention, rwkv6-7b and zamba2-1.2b as above. The stub inputs of phi-3's
vision frontend and whisper's audio frontend are zeros, as the reference's
launcher makes them.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Union

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data.synthetic import TokenTask
from repro_torch.kernels.ops import mixer_launches
from repro_torch.models import build_model
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import stub_shapes


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """The device asked for; raises if it is CUDA and there is none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} was asked for but CUDA is not available; "
                           f"pass device='cpu' (--device cpu) to run on the CPU")
    return dev


@dataclasses.dataclass
class ServeResult:
    tokens: torch.Tensor        # (B, max_new) generated tokens
    logits: torch.Tensor        # (B, max_new, V) the logits each token was picked from
    prefill_s: float
    decode_s: float
    prefill_tok_s: float        # prompt tokens / prefill time
    decode_tok_s: float         # generated tokens after the first / decode time
    launches: dict[str, int]    # launches of each kernel of the path during this call


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _pick(last_logits: torch.Tensor, temperature: float,
          gen: torch.Generator) -> torch.Tensor:
    if temperature <= 0:
        return last_logits.argmax(dim=-1)[:, None]
    probs = torch.softmax(last_logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=gen)


def prompt_batch(cfg: ModelConfig, tokens: torch.Tensor) -> dict:
    """The prefill batch of prompts (B, S): the tokens and the stub inputs,
    zeros in the compute dtype, as the reference's launcher builds them."""
    return {"tokens": tokens,
            **{name: torch.zeros(shape, dtype=getattr(torch, cfg.compute_dtype),
                                 device=tokens.device)
               for name, shape in stub_shapes(cfg, *tokens.shape).items()}}


def serve(cfg: ModelConfig, model: torch.nn.Module,
          prompts: Union[np.ndarray, torch.Tensor], max_new: int, *,
          temperature: float = 0.0, seed: int = 0) -> ServeResult:
    """Prefill `prompts` (B, S) and generate `max_new` tokens per request on
    the model's device. Times end in a device synchronize."""
    if max_new < 1:
        raise ValueError(f"max_new must be >= 1, got {max_new}")
    device = next(model.parameters()).device
    tokens = torch.as_tensor(prompts, device=device)
    n_req, prompt_len = tokens.shape
    bundle = build_model(cfg)
    batch = prompt_batch(cfg, tokens)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    launches_before = mixer_launches(cfg.family)
    with torch.inference_mode():
        _sync(device)
        t0 = time.perf_counter()
        logits, cache = bundle.prefill(model, batch, pad_to=prompt_len + max_new)
        _sync(device)
        t_prefill = time.perf_counter() - t0

        step_logits = [logits[:, -1]]
        tok = _pick(logits[:, -1], temperature, gen)
        generated = [tok]
        t0 = time.perf_counter()
        for _ in range(max_new - 1):
            logits, cache = bundle.decode(model, cache, {"tokens": tok})
            step_logits.append(logits[:, -1])
            tok = _pick(logits[:, -1], temperature, gen)
            generated.append(tok)
        _sync(device)
        t_decode = time.perf_counter() - t0
    return ServeResult(
        tokens=torch.cat(generated, dim=1),
        logits=torch.stack(step_logits, dim=1),
        prefill_s=t_prefill, decode_s=t_decode,
        prefill_tok_s=n_req * prompt_len / max(t_prefill, 1e-9),
        decode_tok_s=n_req * (max_new - 1) / max(t_decode, 1e-9),
        launches={name: n - launches_before[name]
                  for name, n in mixer_launches(cfg.family).items()})


def main(argv=None) -> ServeResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=args.reduced)
    device = resolve_device(args.device)
    model = build_model(cfg).init(args.seed, device)
    task = TokenTask(vocab_size=cfg.vocab_size, seed=args.seed)
    prompts = task.sample(args.requests, args.prompt_len, stream=0)

    res = serve(cfg, model, prompts, args.max_new,
                temperature=args.temperature, seed=args.seed)
    print(f"device : {device}")
    print(f"prefill: {args.requests}x{args.prompt_len} tok in {res.prefill_s:.3f}s "
          f"({res.prefill_tok_s:.0f} tok/s)")
    print(f"decode : {args.max_new - 1} steps in {res.decode_s:.3f}s "
          f"({res.decode_tok_s:.0f} tok/s)")
    for name, n in res.launches.items():
        print(f"{name} kernel launches: {n}")
    print("sample continuation (request 0):", res.tokens[0][:12].tolist())
    return res


if __name__ == "__main__":
    main()
