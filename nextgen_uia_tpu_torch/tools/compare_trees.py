"""Time the whole-block kernel (K1) in this checkout and in another one, in
turns, on one card:

    python -m nextgen_uia_tpu_torch.tools.compare_trees OTHER_CHECKOUT

OTHER_CHECKOUT is a second copy of the repository (for example the parent
commit unpacked with ``git archive`` into ``build/``). Each turn is a fresh
process that builds that tree's kernels and prints three CUDA-event means
of 20 calls of ``fused_block_infer`` at [32, 197, 768] bf16, 12 heads, in
the order other, this, this, other.
"""

from __future__ import annotations

import os
import subprocess
import sys

TIMING = r'''
import sys, torch
sys.path.insert(0, ".")
from nextgen_uia_tpu_torch.models.vit import Block, ViTConfig
from nextgen_uia_tpu_torch.ops import build, fused_block as fb
build.build(); build.library()
g = torch.Generator().manual_seed(0)
blk = Block(g, ViTConfig(width=768, heads=12)).cuda()
x = torch.randn(32, 197, 768, generator=g).cuda().to(torch.bfloat16)
kw = dict(heads=12, act="gelu", eps=1e-6)
with torch.no_grad():
    for _ in range(3):
        fb.fused_block_infer(x, blk, **kw)
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    res = []
    for _ in range(3):
        s.record()
        for _ in range(20):
            fb.fused_block_infer(x, blk, **kw)
        e.record()
        torch.cuda.synchronize()
        res.append(s.elapsed_time(e) / 20)
print("K1_MS", " ".join(f"{r:.4f}" for r in res))
'''


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1 or not os.path.isdir(argv[0]):
        raise SystemExit("usage: python -m nextgen_uia_tpu_torch.tools.compare_trees "
                         "OTHER_CHECKOUT")
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    for name, tree in (("other", argv[0]), ("this", here), ("this", here),
                       ("other", argv[0])):
        res = subprocess.run([sys.executable, "-c", TIMING], cwd=tree, capture_output=True,
                             text=True)
        lines = [ln for ln in res.stdout.splitlines() if ln.startswith("K1_MS")]
        print(name, lines[0] if lines else res.stderr[-2000:])


if __name__ == "__main__":
    main()
