"""Precompute prompt embeddings offline for GenEval / VBench sampling (the
port of ``scripts/precompute_prompts.py``, with its arguments):

    python -m nova_pointcloud_tpu_torch.scripts.precompute_prompts \\
        --prompts prompts.jsonl --out embeds.npz \\
        --phi-checkpoint <dir> --tokenizer <dir>

Every prompt is encoded once by the frozen Phi encoder, so the sampler
(``evaluation/samplers``, ``prompt_embeds=``) never holds the text encoder
beside the generator. The output is one ``.npz``: ``embeds`` (N, L, D)
float16, ``lengths`` (N,) int32 and ``prompts``. Prompts come from a JSON
list, JSONL with "prompt" fields, or plain text one per line.
``--phi-checkpoint`` is a local file of torch Phi weights or a directory
of them (``*.safetensors``, else ``*.bin`` / ``*.pt``, read as
``from_pretrained`` reads a component); a directory with a
``config.json`` (an HF ``save_pretrained``) gives the model's sizes, else
they are phi-2's. The tokenizer is a local HF tokenizer
directory, loaded through ``transformers`` (a pad token defaults to the
EOS token). Without ``--phi-checkpoint`` the deterministic
``DummyTextEncoder`` writes the same format (smoke runs).
"""

import argparse
import json
import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from nova_pointcloud_tpu_torch.utils.device import resolve_device


def load_prompts(path: str) -> List[str]:
    with open(path) as f:
        text = f.read()
    try:
        data = json.loads(text)
        if isinstance(data, list):
            return [p if isinstance(p, str) else p["prompt"] for p in data]
        if isinstance(data, dict) and "prompts" in data:
            return list(data["prompts"])
    except json.JSONDecodeError:
        pass
    prompts = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
            prompts.append(rec["prompt"] if isinstance(rec, dict) else rec)
        except json.JSONDecodeError:
            prompts.append(line)
    return prompts


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--prompts", required=True,
                    help="JSON list / JSONL with 'prompt' / one-per-line txt")
    ap.add_argument("--out", required=True, help="output .npz")
    ap.add_argument("--phi-checkpoint", default=None,
                    help="local dir or file with torch Phi weights")
    ap.add_argument("--tokenizer", default=None,
                    help="local HF tokenizer dir (required with --phi-checkpoint)")
    ap.add_argument("--max-tokens", type=int, default=256)
    ap.add_argument("--batch-size", type=int, default=16)
    return ap.parse_args(argv)


def _phi_state(path: str):
    """(state dict, HF config dict) of a Phi checkpoint file or directory."""
    from nova_pointcloud_tpu_torch.pipelines.pretrained import _read_json, _read_state_dict

    if not os.path.isdir(path):
        return torch.load(path, map_location="cpu"), {}
    cfg_path = os.path.join(path, "config.json")
    return _read_state_dict(path), _read_json(cfg_path) if os.path.exists(cfg_path) else {}


def _phi_encoder(args, dev):
    from transformers import AutoTokenizer

    from nova_pointcloud_tpu_torch.models.text_encoders.phi import (
        PhiConfig, PhiEncoderModel, PhiTextEncoder, load_torch_phi_weights)

    if not args.tokenizer:
        raise SystemExit("--tokenizer is required with --phi-checkpoint")
    tokenizer = AutoTokenizer.from_pretrained(args.tokenizer)
    if tokenizer.pad_token is None:
        tokenizer.pad_token = tokenizer.eos_token
    state, cfg = _phi_state(args.phi_checkpoint)
    model = PhiEncoderModel(PhiConfig.from_hf(cfg), device=dev)
    model.load_state_dict(load_torch_phi_weights(model, state))
    return PhiTextEncoder(model, tokenizer, num_tokens=args.max_tokens)


def main(argv: Optional[Sequence[str]] = None, device=None) -> str:
    """Encode and write ``--out``; returns its path. ``device``: the card
    unless "cpu" is asked for."""
    args = parse_args(argv)
    dev = resolve_device(device)
    prompts = load_prompts(args.prompts)
    print(f"{len(prompts)} prompts from {args.prompts}")
    if args.phi_checkpoint:
        encoder = _phi_encoder(args, dev)
    else:
        from nova_pointcloud_tpu_torch.models.text_encoders.dummy import DummyTextEncoder

        print("no --phi-checkpoint: using DummyTextEncoder (smoke mode)")
        encoder = DummyTextEncoder(256, args.max_tokens)
    embeds, lengths = [], []
    for i in range(0, len(prompts), args.batch_size):
        e, n = encoder.encode(prompts[i: i + args.batch_size])
        embeds.append(np.asarray(e, np.float16))
        lengths.append(np.asarray(n, np.int32))
        if i and i % (10 * args.batch_size) == 0:
            print(f"  {i}/{len(prompts)}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    embeds = np.concatenate(embeds)
    np.savez_compressed(args.out, embeds=embeds, lengths=np.concatenate(lengths),
                        prompts=np.asarray(prompts, dtype=object))
    print(f"wrote {args.out}: embeds {embeds.shape}")
    return args.out


if __name__ == "__main__":
    main()
