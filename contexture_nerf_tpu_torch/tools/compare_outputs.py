"""PSNR harness for results users produce; counterpart of
tools/compare_outputs.py.

    python -m contexture_nerf_tpu_torch.tools.compare_outputs REF OUT \
        [--threshold 30]

Pairs the png/jpg files of the two directories by name, resizes the second
of a pair to the first's size when they differ, prints each pair's PSNR and
a JSON summary line; exits 1 when a file of REF has no pair in OUT, when
there is no pair, or when a pair lands under the threshold.
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np


def load_image(path: Path) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    """PSNR in dB of b against a, both in [0, 1]; b resized to a's size
    (Pillow's default filter) when the shapes differ; inf when equal."""
    if a.shape != b.shape:
        from PIL import Image

        im = Image.fromarray((b * 255).astype(np.uint8)).resize(
            (a.shape[1], a.shape[0]))
        b = np.asarray(im, np.float32) / 255.0
    mse = float(np.mean((a - b) ** 2))
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(1.0 / mse))


def compare_dirs(ref_dir: Path, out_dir: Path):
    """({name: PSNR} over the images both directories hold, [names of REF
    missing in OUT])."""
    exts = {".png", ".jpg", ".jpeg"}
    refs = {p.name: p for p in sorted(Path(ref_dir).iterdir())
            if p.suffix.lower() in exts}
    outs = {p.name: p for p in sorted(Path(out_dir).iterdir())
            if p.suffix.lower() in exts}
    common = sorted(set(refs) & set(outs))
    results = {name: psnr(load_image(refs[name]), load_image(outs[name]))
               for name in common}
    return results, sorted(set(refs) - set(outs))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("ref_dir", type=Path)
    ap.add_argument("out_dir", type=Path)
    ap.add_argument("--threshold", type=float, default=30.0)
    args = ap.parse_args(argv)

    results, missing = compare_dirs(args.ref_dir, args.out_dir)
    for name, value in results.items():
        print(f"  {name}: {value:.2f} dB")
    worst = min(results.values()) if results else float("nan")
    ok = bool(results) and not missing and worst >= args.threshold
    print(json.dumps({"metric": "psnr_vs_reference_db_worst",
                      "value": round(worst, 2), "unit": "dB",
                      "pairs": len(results), "missing": missing,
                      "threshold": args.threshold, "pass": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
