"""Serving launcher: waves of requests under k-Segments HBM admission.

Port of ``repro.launch.serve``.  Requests arrive with random prompt
lengths; the engine prefills and decodes each admitted wave greedily, and
the admission controller (the paper's technique, applied beyond the paper)
gates entry against the HBM budget using learned memory-over-time
predictions.  ``main()`` serves the reduced config like the reference;
``serve_requests`` runs the same loop for any config and model, the full
one included.  Runs on the CUDA card unless given ``--device cpu``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b --requests 24 --device cpu
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.model import Transformer, init_params
from repro_torch.serve.admission import AdmissionController, cache_bytes_per_token
from repro_torch.serve.engine import greedy_generate

WAVE = 4  # requests a wave at most


def serve_requests(cfg: ModelConfig, model: Transformer, ctl: AdmissionController, *, requests: int = 24,
                   decode_steps: int = 16, bytes_per_token_mib: float, device=None, log=print) -> dict:
    """Serve ``requests`` requests in waves of at most ``WAVE``: admit while
    the controller accepts, generate ``decode_steps`` tokens for the wave,
    then feed each request's memory curve (prompt then one token a step, at
    ``bytes_per_token_mib``) back to the controller and release it.

    Prompt lengths come from ``np.random.default_rng(0)``, prompt tokens
    from a ``torch.Generator`` seeded with the wave's number.  Returns the
    counts, the wall time and each wave's (B, decode_steps) tokens."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    done, rejected, wave = 0, 0, 0
    outputs = []
    t0 = time.time()
    while done < requests:
        wave += 1
        batch_prompts = []
        while len(batch_prompts) < WAVE and done + len(batch_prompts) < requests:
            plen = int(rng.integers(8, 48))
            rid = f"w{wave}-r{len(batch_prompts)}"
            if ctl.try_admit(rid, plen, now=time.time() - t0) is None:
                rejected += 1
                break
            batch_prompts.append((rid, plen))
        if not batch_prompts:
            for rid in list(ctl.active):
                ctl.release(rid)
            continue
        maxlen = max(p for _, p in batch_prompts)
        gen = torch.Generator().manual_seed(wave)
        toks = torch.randint(0, cfg.vocab_size, (len(batch_prompts), maxlen), generator=gen, dtype=torch.int32)
        out = greedy_generate(model, cfg, toks.to(dev), steps=decode_steps, device=dev)
        outputs.append(out)
        for rid, plen in batch_prompts:
            # feed the observed memory curve back to the predictor
            series = (plen * bytes_per_token_mib + bytes_per_token_mib * np.arange(decode_steps)).astype(np.float32)
            ctl.observe(plen, series)
            ctl.release(rid)
            done += 1
        log(f"wave {wave}: decoded {tuple(out.shape)} (total {done}/{requests}, rejected {rejected})")
    seconds = time.time() - t0
    log(f"served {done} requests in {seconds:.1f}s, {rejected} deferred by admission")
    return {"done": done, "rejected": rejected, "waves": wave, "seconds": seconds, "outputs": outputs}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--decode-steps", type=int, default=16)
    ap.add_argument("--budget-mib", type=float, default=512.0)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    model = init_params(cfg, seed=0, device=dev)
    bpt = max(cache_bytes_per_token(get_config(args.arch)) / 2**20, 1e-4)
    ctl = AdmissionController(hbm_budget_mib=args.budget_mib, k=4, interval_s=1.0)
    return serve_requests(cfg, model, ctl, requests=args.requests, decode_steps=args.decode_steps,
                          bytes_per_token_mib=bpt, device=dev)


if __name__ == "__main__":
    main()
