"""What exact score ties cost the fold's dq kernel on the attention fit's
own inputs.

Runs one ``SelfAttentionClassifier`` training step at ``chip_smoke.py``'s
fit_attention configuration (E 512, H 4, vocab 1024, T 8192, two seeded
documents, the initial weights), keeps the dq kernel's inputs, and times
the kernel (CUDA events, median of 5) on them; on the same inputs with the
keys moved by 1e-4 · N(0, 1), so no two keys tie; on the first document
alone; and on standard-normal q, k, v. Then counts the rows whose block max
more than ``kMaxKeys`` (32) keys share, and the 64-row blocks holding one:
the dq kernel sums those rows again in a second walk of the key tiles.
Prints one JSON line. Needs one card::

    python3 tools/flash_bwd_ties.py
"""
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as c  # noqa: E402
import flink_ml_tpu_torch.parallel.flash as flash_mod  # noqa: E402
from flink_ml_tpu_torch.models.classification import attention_classifier as attn  # noqa: E402

MAX_KEYS, BLOCK_ROWS = 32, 64  # the dq kernel's max-key slots a row and rows a block


def _median_ms(fn, n=5):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[n // 2]


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    tok, _ = c._attention_documents(c.FIT_ATTN_DOCS, c.FIT_ATTN_TOKEN_SEED)
    init = attn._init_params(np.random.default_rng(c.ATTN_PARAM_SEED), c.ATTN_VOCAB, c.ATTN_E, c.ATTN_CLASSES)
    params = {n: torch.from_numpy(a).to(dev) for n, a in init.items()}
    zeros = {n: torch.zeros_like(p) for n, p in params.items()}
    batch = c.FIT_ATTN_BATCH
    tok_w = torch.from_numpy(tok[:batch]).to(dev).long()
    kept = {}
    real = flash_mod.fold_bwd_dq

    def keep(*args):
        kept["args"] = args
        return real(*args)

    flash_mod.fold_bwd_dq = keep
    try:
        attn._train_step(params, zeros, zeros, 1, tok_w, torch.zeros(batch, dtype=torch.long, device=dev),
                         torch.ones(batch, device=dev), c.FIT_ATTN_T, c.ATTN_H, c.FIT_ATTN_LR)
    finally:
        flash_mod.fold_bwd_dq = real
    args = kept["args"]
    q, k, v = args[:3]
    untied = (k + 1e-4 * torch.randn_like(k)).contiguous()
    first = [x[:1].contiguous() if torch.is_tensor(x) and x.dim() >= 3 else x for x in args]
    randn = [torch.randn_like(x) for x in (q, k, v)]
    out = {
        "card": c.nvidia_smi_line(),
        "shape": list(q.shape),
        "dq_ms": _median_ms(lambda: real(*args)),
        "dq_ms_no_ties": _median_ms(lambda: real(q, untied, *args[2:])),
        "dq_ms_first_document": _median_ms(lambda: real(*first)),
        "dq_ms_standard_normal_qkv": _median_ms(lambda: real(*randn, *args[3:])),
    }
    rows, blocks, mean_ties = 0, 0, []
    for b in range(q.shape[0]):
        for h in range(q.shape[1]):
            ties = []
            for r0 in range(0, q.shape[2], 1024):
                s = q[b, h, r0:r0 + 1024] @ k[b, h].T  # keys of one token are equal rows, so their scores tie
                ties.append((s == s.amax(-1, keepdim=True)).sum(-1))
            ties = torch.cat(ties)
            rows += int((ties > MAX_KEYS).sum())
            blocks += int((ties[: ties.numel() // BLOCK_ROWS * BLOCK_ROWS].reshape(-1, BLOCK_ROWS) > MAX_KEYS)
                          .any(-1).sum())
            mean_ties.append(float(ties.float().mean()))
    out.update(rows_past_slots=rows, blocks_past_slots=blocks,
               blocks=q.shape[0] * q.shape[1] * -(-q.shape[2] // BLOCK_ROWS), mean_ties_per_head=mean_ties)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
