"""Image comparison tool: the ImageComparer as a CLI (counterpart of
stratum_tpu/tools/compare.py; src/Node/ImageComparer.{hpp,cpp}). Prints
MSE / RMSE / SMAPE / relative MSE / means of two images
(``utils.compare``), optionally quantized and with a difference image.

Usage:
    python -m stratum_tpu_torch.tools.compare a.hdr b.hdr [--metric=smape]
        [--diff=out.png] [--quantize=8] [--diffGain=4] [--cpu]

The metrics are reduced on the card unless given ``--cpu``.
"""

from __future__ import annotations

import sys


def main(argv=None) -> int:
    from stratum_tpu_torch.utils.flags import Options

    opts = Options(sys.argv[1:] if argv is None else argv)
    if len(opts.positional) < 2:
        print(__doc__)
        return 1
    import numpy as np
    import torch

    from stratum_tpu_torch.io.image import load_image, save_image
    from stratum_tpu_torch.tools import device_of
    from stratum_tpu_torch.utils import compare as metrics

    device = device_of(opts)
    a = np.asarray(load_image(opts.positional[0], srgb=False))[..., :3]
    b = np.asarray(load_image(opts.positional[1], srgb=False))[..., :3]
    if a.shape != b.shape:
        print(f"shape mismatch: {a.shape} vs {b.shape}")
        return 1
    a = torch.as_tensor(a, dtype=torch.float32, device=device)
    b = torch.as_tensor(b, dtype=torch.float32, device=device)
    # the reference comparer's quantization mode
    q = opts.get_int("quantize", 0)
    if q:
        scale = (1 << q) - 1
        a = torch.round(torch.clamp(a, 0, 1) * scale) / scale
        b = torch.round(torch.clamp(b, 0, 1) * scale) / scale
    results = {
        "mse": float(metrics.mse(a, b)),
        "rmse": float(metrics.rmse(a, b)),
        "smape": float(metrics.smape(a, b)),
        "relmse": float(metrics.relative_mse(a, b)),
        "mean_a": float(metrics.average(a)),
        "mean_b": float(metrics.average(b)),
    }
    wanted = opts.get_str("metric", "")
    if wanted:
        print(results[wanted])
    else:
        for k, v in results.items():
            print(f"{k:8s} {v:.6g}")
    diff_out = opts.get_str("diff", "")
    if diff_out:
        gain = opts.get_float("diffGain", 4.0)
        d = torch.clamp(torch.abs(a - b) * gain, 0, 1)
        save_image(diff_out, d.cpu().numpy(), tonemapped=True)
        print(f"wrote {diff_out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
