"""Serving driver: batched prefill + greedy decode with static-shape caches.

The counterpart of ``repro.launch.serve``.  Requests arrive with
different prompt lengths; prompts are left-padded into the prefill batch
and decode proceeds in lock step.  ``serve_queue`` parks requests on a
:class:`~repro_torch.runtime.scheduler.SlotScheduler` of ``slots`` slots
and serves them in FIFO waves of at most ``slots`` requests, so an
open-ended request stream runs under a bounded decode batch.

Weights are random, drawn on the card from a seeded generator
(:func:`repro_torch.models.transformer.init_params`).  The prefill runs
the ``rglru_scan`` and ``flash_attention`` kernels (RecurrentGemma), the
``ssd_scan`` kernel (Mamba-2) or ``flash_attention`` in every layer (the
uniform attention stack: Yi, Gemma, GLM-4, gemma3, the MoE models OLMoE
and Mixtral, and phi-3-vision; whisper's encoder, decoder and
cross-attention) on the card.  Whisper's prefill reads the batch's frame
embeddings (B, 1500, 1280) and phi-3-vision's its patch embeddings (B,
144, 3072), prepended, so that its caches and decode positions run P =
144 past the prompt's; as in the reference, they are zeros unless the
caller passes them (``extras``).  For Mamba-2 the longest
prompt of a batch must be a multiple of the SSD chunk or shorter than
it, as in the reference (the CLI draws lengths below ``--prompt-len``).
For both recurrent models it must have at least 3 tokens, the conv
width minus one; a shorter one raises ``ValueError`` (the CLI draws 4 or more).

``serve_batch(mesh=...)`` and ``serve_queue(mesh=...)`` run the same
loop on a :class:`~repro_torch.runtime.mesh.ProcessMesh`, as the
reference's docstring says its loop runs under the production mesh:
every rank runs it with its blocks of the params (``param_specs``) and
the whole requests, through ``make_prefill_step(mesh=)`` and
``make_serve_step(mesh=, cache_shapes=)``.  Each rank keeps its blocks
of the cache (kv heads split over "model", slots split over "model", or
rows alone) and never gathers it; each rank computes its share of the
heads, channels and vocab rows (tensor-parallel on "model"), its blocks
gathered over their FSDP axes once into that share.  Greedy
tokens come from the whole logits, gathered from the ranks' blocks;
sampling draws from the same seeded generator on every rank, so every
rank ends with the same ``out`` lists.  The CLI has no mesh flag, as the
reference's has none.

Usage (the card by default; ``--device cpu`` for a CPU run):
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch recurrentgemma-9b|whisper-large-v3|phi3-vision-4.2b|... \
      [--smoke] \
      --batch 4 --prompt-len 32 --max-new 16 [--slots 2] [--seed 0] \
      [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch import device as device_mod
from repro_torch.models import transformer
from repro_torch.runtime import sharding
from repro_torch.runtime import steps as steps_mod
from repro_torch.runtime.scheduler import SlotScheduler


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (len,) int32
    max_new: int
    out: list = dataclasses.field(default_factory=list)


def modality_inputs(cfg, batch: int, device) -> dict:
    """The batch's inputs besides its tokens, zeros as the reference
    serves them: whisper's frame embeddings (B, encoder_seq, d_model),
    phi-3-vision's patch embeddings (B, num_patches, d_model), nothing
    for a text-only model."""
    dtype = transformer.DTYPES[cfg.dtype]
    if cfg.frontend == "audio_stub":
        return {"frames": torch.zeros((batch, cfg.encoder_seq, cfg.d_model),
                                      dtype=dtype, device=device)}
    if cfg.frontend == "vision_stub":
        return {"patches": torch.zeros((batch, cfg.num_patches,
                                        cfg.d_model), dtype=dtype,
                                       device=device)}
    return {}


def serve_batch(cfg, params, requests, *, max_seq: int, greedy: bool = True,
                seed: int = 0, extras: dict | None = None, mesh=None):
    """Run a batch of requests to completion on the device of the
    weights.  Returns the requests with ``out`` filled, plus timing
    stats (host wall times that end in a wait for the device).
    ``greedy=False`` samples from a ``torch.Generator`` seeded with
    ``seed``.  ``extras``: the batch's frames or patches (one row a
    request), :func:`modality_inputs`' zeros by default; patches run the
    cache and the decode positions ``num_patches`` further.  With
    ``mesh`` ``params`` are this rank's blocks and every rank of the
    mesh calls this with the same requests (the rank's tensor-parallel
    share of the params, gathered on the first call, is kept by the mesh
    for later ones)."""
    dev = params["embed"].device
    B = len(requests)
    S = max(len(r.prompt) for r in requests)
    # right-align prompts (left padding) so decode positions line up
    toks = np.zeros((B, S), np.int64)
    for i, r in enumerate(requests):
        toks[i, S - len(r.prompt):] = r.prompt
    batch = {"tokens": torch.as_tensor(toks, device=dev)}
    batch.update(modality_inputs(cfg, B, dev) if extras is None else extras)
    P_off = cfg.num_patches if cfg.frontend == "vision_stub" else 0

    t0 = time.perf_counter()
    if mesh is None:
        prefill = steps_mod.make_prefill_step(cfg, max_seq=max_seq + P_off)
        serve = steps_mod.make_serve_step(cfg)
        whole_logits = lambda x: x      # noqa: E731
    else:
        prefill = steps_mod.make_prefill_step(cfg, mesh, max_seq + P_off)
        serve = steps_mod.make_serve_step(
            cfg, mesh, transformer.init_decode_cache(
                cfg, B, max_seq + P_off, device="meta"))
        whole_logits = lambda x: sharding.gather(  # noqa: E731
            x, serve.logits_sharding)
    logits, cache = device_mod.block(prefill(params, batch))
    prefill_s = time.perf_counter() - t0

    gen = None if greedy else torch.Generator(device=dev).manual_seed(seed)
    cur = torch.argmax(logits, -1)[:, None]
    max_new = max(r.max_new for r in requests)
    t1 = time.perf_counter()
    for step in range(max_new):
        ids = cur[:, 0].tolist()
        for i, r in enumerate(requests):
            if step < r.max_new:
                r.out.append(int(ids[i]))
        logits, cache = serve(params, cache, cur, P_off + S + step)
        logits = whole_logits(logits)
        if greedy:
            cur = torch.argmax(logits, -1)
        else:
            probs = torch.softmax(logits[:, 0].float(), dim=-1)
            cur = torch.multinomial(probs, 1, generator=gen)
    device_mod.block(cur)
    decode_s = time.perf_counter() - t1
    stats = {
        "prefill_s": prefill_s,
        "decode_s": decode_s,
        "tokens_per_s": B * max_new / decode_s if decode_s else 0.0,
    }
    return requests, stats


def serve_queue(cfg, params, requests, *, slots: int, max_seq: int,
                greedy: bool = True, seed: int = 0, mesh=None):
    """Run an unbounded request list through a bounded decode batch.

    Requests are parked on a :class:`SlotScheduler` of ``slots`` slots
    and served in FIFO waves: admit up to ``slots``, run the wave with
    :func:`serve_batch`, retire, repeat until the queue drains.  Returns
    the completed requests (arrival order) and aggregate stats.  With
    ``mesh`` every rank runs every wave on its param blocks, gathered
    into its tensor-parallel share once for all the waves.
    """
    sched = SlotScheduler(capacity=slots, meters_prefix="serve.")
    for r in requests:
        sched.submit(r)
    done = []
    waves = 0
    agg = {"prefill_s": 0.0, "decode_s": 0.0}
    while not sched.idle():
        wave = sched.admit()
        batch = [r for _, r in wave]
        batch, stats = serve_batch(cfg, params, batch, max_seq=max_seq,
                                   greedy=greedy, seed=seed + waves,
                                   mesh=mesh)
        for slot, _ in wave:
            sched.retire(slot)
        done.extend(batch)
        agg["prefill_s"] += stats["prefill_s"]
        agg["decode_s"] += stats["decode_s"]
        waves += 1
    total_new = sum(len(r.out) for r in done)
    agg["waves"] = waves
    agg["tokens_per_s"] = (total_new / agg["decode_s"]
                           if agg["decode_s"] else 0.0)
    return done, agg


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--slots", type=int, default=0,
                    help="decode-batch slot count (0 = one wave of "
                         "--batch requests, no queueing)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = (configs.get_smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    params = transformer.init_params(cfg, args.seed, device=args.device)
    rng = np.random.default_rng(args.seed)
    reqs = [Request(rid=i,
                    prompt=rng.integers(1, cfg.vocab_size,
                                        rng.integers(4, args.prompt_len),
                                        dtype=np.int64).astype(np.int32),
                    max_new=args.max_new)
            for i in range(args.batch)]
    if args.slots > 0:
        reqs, stats = serve_queue(cfg, params, reqs, slots=args.slots,
                                  max_seq=args.prompt_len + args.max_new)
    else:
        reqs, stats = serve_batch(cfg, params, reqs,
                                  max_seq=args.prompt_len + args.max_new)
    for r in reqs:
        print(f"req {r.rid}: prompt[{len(r.prompt)}] -> {r.out[:8]}...")
    print(f"prefill {stats['prefill_s']:.3f}s decode {stats['decode_s']:.3f}s "
          f"({stats['tokens_per_s']:.1f} tok/s)")


if __name__ == "__main__":
    main()
