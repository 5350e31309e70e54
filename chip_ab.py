"""A/B timing of one tree of the PyTorch/CUDA port on one GPU.

    python3 chip_ab.py LABEL

Run from the root of a tree (this checkout, or another commit unpacked with
``git archive`` into a gitignored directory such as ``build/``). It builds the
kernels, checks each against its plain version once, times each per launch
at both batch sizes of the flagship path (CUDA events), and times the
flagship pipeline (p50 of 3 calls at batch 128, after a 2-step
calibration). It prints one line, ``AB {json}``. To compare two trees,
run both in one session on one card, alternating: A, B, B, A.
"""

import json
import sys
import time

import numpy as np
import torch

import chip_smoke as cs


def main(label: str) -> None:
    if not torch.cuda.is_available():
        cs._fail("CUDA is not available: this script runs on the GPU only", 2)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    cs._build.build_all()
    res = {"label": label, "build_s": time.perf_counter() - t0}
    gen = torch.Generator(device="cuda").manual_seed(5)
    for name, (kind, kernel, plain) in cs._kernels().items():
        kw = dict(cs._variants(kind)[0][1])  # the flagship variant
        for n in (cs.FLAGSHIP_SHAPE[kind], cs.FLAGSHIP_SHAPE[kind] // 2):
            ops = cs._kernel_operands(gen, n, kind)
            err = (kernel(*ops, **kw).float() - plain(*ops, **kw).float()).abs()
            res[f"{name}_{n}_err"] = [err.max().item(), err.mean().item()]
            res[f"{name}_{n}_ms"] = cs.sync_ms(lambda: kernel(*ops, **kw), 20)
            del ops, err
    pipe = cs._make_pipeline()
    pipe.calibrate(prompt_embeds=pipe.encode_prompt(cs.PROMPTS), num_points=cs.POINTS,
                   num_diffusion_steps=2)
    cs._sample(pipe, seed=9)
    times = []
    for i in range(3):
        t0 = time.perf_counter()
        cs._sample(pipe, seed=20 + i)
        times.append(time.perf_counter() - t0)
    res["pipeline_p50_s"] = float(np.percentile(times, 50))
    res["samples_per_s"] = cs.BATCH / res["pipeline_p50_s"]
    print("AB " + json.dumps(res), flush=True)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "tree")
