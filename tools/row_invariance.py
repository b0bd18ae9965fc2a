"""Whether a row's result depends on how many rows share its call.

The sharded plan tier (``flink_ml_tpu_torch/servable/sharding.py``) holds a
shard of ``m`` rows bit-equal, row by row, to the same rows inside the
unsharded bucket. That holds only for operations whose per-row result does
not move with the row count. This script runs the exact tier's products and
reductions — the margins ``X @ coef``, the distance product
``X @ centroids.T``, the MLP's ``h @ W``, row sums, softmax, sigmoid — on a
4096-row batch and on every aligned ``m``-row slice of it, for ``m`` a
multiple of 8, and prints one JSON line per (operation, shape) with the row
counts whose slices differ from the full batch. It also runs the port's
row-stable forms (``flink_ml_tpu_torch.ops.rowstable``) the same way, inside
``rowstable.required()``, where a sharded plan runs them on the card.

    python3 tools/row_invariance.py            # on the card (the default)
    python3 tools/row_invariance.py --device cpu
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from flink_ml_tpu_torch.ops import rowstable  # noqa: E402

ROWS = 4096
SLICES = (8, 16, 24, 32, 40, 64, 128, 256, 512, 1024, 2048)


def _differing(fn, x: torch.Tensor) -> list:
    full = fn(x)
    bad = []
    for m in SLICES:
        for lo in range(0, ROWS, m):
            part = fn(x[lo:lo + m].clone())
            if not torch.equal(part, full[lo:lo + m]):
                bad.append(m)
                break
    return bad


def _bmm8(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` as a batch of 8-row products (one shape whatever the rows)."""
    return torch.matmul(x.reshape(-1, 8, x.shape[1]), w).reshape(x.shape[0], -1)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no card")
    gen = torch.Generator().manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen).to(device)

    cases = []
    for d in (8, 16, 100, 256):
        x, coef = rnd(ROWS, d), rnd(d)
        cases.append((f"mv d{d}", lambda x, c=coef: x @ c, x))
        cases.append((f"rowstable.matmul mv d{d}", lambda x, c=coef: rowstable.matmul(x, c), x))
        for k in (3, 10):
            c = rnd(k, d)
            cases.append((f"mm d{d} k{k}", lambda x, c=c: x @ c.T, x))
            cases.append((f"rowstable.matmul d{d} k{k}", lambda x, c=c: rowstable.matmul(x, c.T), x))
            cases.append((f"bmm8 d{d} k{k}", lambda x, c=c: _bmm8(x, c.T), x))
        cases.append((f"sum(x*x) d{d}", lambda x: torch.sum(x * x, dim=1), x))
        cases.append((f"rowstable.sum_last(x*x) d{d}", lambda x: rowstable.sum_last(x * x), x))
        cases.append((f"sigmoid alone d{d}", lambda x: torch.sigmoid(x[:, 0]), x))
        cases.append((f"sigmoid d{d}", lambda x, c=coef: torch.sigmoid(x @ c), x))
        cases.append((f"rowstable.sigmoid d{d}", lambda x, c=coef: rowstable.sigmoid(rowstable.matmul(x, c)), x))
    for d_in, d_out in ((256, 512), (512, 512), (512, 8), (32, 128), (128, 4)):
        x, w = rnd(ROWS, d_in), rnd(d_in, d_out)
        cases.append((f"mm {d_in}x{d_out}", lambda x, w=w: x @ w, x))
        cases.append((f"rowstable.matmul {d_in}x{d_out}", lambda x, w=w: rowstable.matmul(x, w), x))
        cases.append((f"bmm8 {d_in}x{d_out}", lambda x, w=w: _bmm8(x, w), x))
    for c in (2, 8):
        x = rnd(ROWS, c)
        cases.append((f"softmax {c}", lambda x: torch.softmax(x, dim=-1), x))
    name = torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu"
    with rowstable.required():
        for label, fn, x in cases:
            print(json.dumps({"device": name, "op": label, "differs_at_rows": _differing(fn, x)}),
                  flush=True)
        if device.type == "cuda":
            _time_products(rnd, name)


def _time_products(rnd, name: str) -> None:
    """CUDA-event times of the row-stable products against cuBLAS at the
    published widths, 4096 rows."""
    for label, a, b in (("mlp 256x512", rnd(ROWS, 256), rnd(256, 512)),
                        ("mlp 512x512", rnd(ROWS, 512), rnd(512, 512)),
                        ("mlp 512x8", rnd(ROWS, 512), rnd(512, 8)),
                        ("kmeans 100x10", rnd(ROWS, 100), rnd(100, 10)),
                        ("logistic 100", rnd(ROWS, 100), rnd(100))):
        row = {"device": name, "product": label, "rows": ROWS}
        for key, fn in (("cublas_ms", lambda: a @ b), ("rowstable_ms", lambda: rowstable.matmul(a, b))):
            for _ in range(3):
                fn()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                fn()
            end.record()
            torch.cuda.synchronize()
            row[key] = start.elapsed_time(end) / 20
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
