"""Numerics of every log-mel path against the float64 golden, on the card.

    python -m audio_classification_icbhi_tpu_torch.parity [--out PATH] [--device cpu]

The port's counterpart of the JAX package's `bench.py --parity`
(`bench.py:219-300`): the same battery (`ops/golden.parity_battery`), the
same durations (5 s clips and 1 s analyzer windows), the same shape (n_fft
2048, hop 512, 128 mels at 16 kHz) and the same rows, one JSON line each:

- `numpy_f32`: the chain in pure float32 numpy, the floor of any f32
  implementation;
- `pallas_<algorithm>` for the eight kernel algorithms, through their
  wrappers (`ops/mel_kernels.WRAPPERS`), and
  `pallas_radix{16,8}dif_fused_passes{4,6}`, the pass budgets the JAX
  package offers (the Hopper kernels accept and ignore them);
- `xla_radix2` and `xla_matmul_dft`: `MelFrontend(backend="xla_radix2")`
  and `MelFrontend(backend="xla")`, the plain torch chain.

Each line has the keys of the JAX package's `PARITY_r05.json`: the largest
dB error over every cell, over the cells within 25 dB of their clip's
golden peak (the active region), and whether each is within 1e-3. Runs on
the card (the kernels) unless given `--device cpu`, where every wrapper runs
its plain version. Writes only to `--out`, when given.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from audio_classification_icbhi_tpu_torch.ops import mel_kernels
from audio_classification_icbhi_tpu_torch.ops.golden import (
    golden_mel,
    golden_mel_f32,
    parity_battery,
)
from audio_classification_icbhi_tpu_torch.ops.mel import PORTED_ALGORITHMS, MelFrontend

SR, N_FFT, HOP, N_MELS = 16000, 2048, 512, 128
DURATIONS = (5.0, 1.0)  # headline clips, analyzer windows
BUDGET_DB = 1e-3
# the pass-budget rows: the JAX package's production DIF kernels
PASS_ROWS = (("radix16dif_fused", 4), ("radix16dif_fused", 6), ("radix8dif_fused", 4),
             ("radix8dif_fused", 6))


def parity(device: str | torch.device = "cuda", n_fft: int = N_FFT, hop: int = HOP,
           durations=DURATIONS, algorithms=PORTED_ALGORITHMS) -> list[dict]:
    """Every row at each duration, in the JAX package's order: a list of
    dicts with its JSON keys. `algorithms` names the wrappers to run (every
    one takes 2048/512; at other shapes pass the ones whose shape contract
    holds); the pass-budget rows run for those of them that have one."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu for the plain versions")
    platform = "gpu" if device.type == "cuda" else "cpu"
    results = []
    for duration in durations:
        wavs = parity_battery(int(SR * duration))
        want = np.stack([golden_mel(w, SR, n_fft, hop, N_MELS) for w in wavs])
        active = want >= want.max(axis=(1, 2), keepdims=True) - 25.0
        x = torch.from_numpy(wavs).to(device)

        def record(name, got):
            d = np.abs(np.asarray(got, np.float64) - want)
            err, err25 = float(d.max()), float(d[active].max())
            results.append({"algorithm": name, "duration_s": duration, "platform": platform,
                            "max_abs_db_err": round(err, 8),
                            "max_abs_db_err_25db": round(err25, 8),
                            "within_budget": err25 <= BUDGET_DB,
                            "within_budget_unrestricted": err <= BUDGET_DB})

        def run(name, fn):
            got = fn()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            record(name, got.double().cpu().numpy())

        record("numpy_f32", np.stack([golden_mel_f32(w, SR, n_fft, hop, N_MELS) for w in wavs]))
        for alg in algorithms:
            run(f"pallas_{alg}", lambda a=alg: mel_kernels.WRAPPERS[a](x, SR, n_fft, hop, N_MELS))
        for alg, passes in PASS_ROWS:
            if alg in algorithms:
                run(f"pallas_{alg}_passes{passes}", lambda a=alg, p=passes: mel_kernels.WRAPPERS[a](
                    x, SR, n_fft, hop, N_MELS, dft_passes=p))
        for name, backend in (("xla_radix2", "xla_radix2"), ("xla_matmul_dft", "xla")):
            frontend = MelFrontend(SR, N_MELS, n_fft, hop, duration, normalize=False,
                                   backend=backend)
            run(name, lambda fe=frontend: fe(x))
    return results


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="write the JSON lines to this file")
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu")
    args = ap.parse_args(argv)
    # the xla rows are the plain f32 chain: TF32 would cut its products to
    # 10 mantissa bits
    torch.backends.cuda.matmul.allow_tf32 = False
    results = parity(args.device)
    lines = [json.dumps(r) for r in results]
    print("\n".join(lines), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("".join(line + "\n" for line in lines))
    worst = max(r["max_abs_db_err_25db"] for r in results)
    print(f"# worst active-region error {worst:.2e} dB over {len(results)} rows"
          + (f" -> {args.out}" if args.out else ""), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
