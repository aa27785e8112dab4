"""Row bits of a norm's mean against the number of rows sharing the call.

For each width d and row count M, counts the rows of x[:M] whose mean of
squares differs in any bit from the same rows' in one call over 1,024 rows:
``torch.mean`` (whose CUDA reduction picks its order from the row count)
against the port's halving mean (``models/layers.py::_row_mean``, what
``rmsnorm`` and ``layernorm`` use). x is bf16 widened to fp32, as in the
norms. Prints the card's name and power limit, then one JSON object.

    PYTHONPATH=src python3 scripts/torch_norm_row_bits.py [--device cpu]
"""
import argparse
import json
import subprocess

import torch

from repro_torch.models.layers import _row_mean

WIDTHS = (576, 1536, 2048, 3584, 4096, 5120, 6144, 8192)
ROWS = (1, 2, 8, 16, 64, 96, 128, 512)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = ap.parse_args().device
    if dev == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip())
    gen = torch.Generator(device=dev).manual_seed(0)
    means = {"torch.mean": lambda t: torch.mean(t, -1, keepdim=True),
             "_row_mean": _row_mean}
    out = {name: {} for name in means}
    for d in WIDTHS:
        x = torch.randn((1024, d), generator=gen, device=dev)
        sq = torch.square(x.to(torch.bfloat16).float())
        for name, mean in means.items():
            full = mean(sq)
            out[name][d] = {M: int((mean(sq[:M]) != full[:M]).sum())
                            for M in ROWS}
    print(json.dumps({"rows_differing_from_M_1024": out}))


if __name__ == "__main__":
    main()
