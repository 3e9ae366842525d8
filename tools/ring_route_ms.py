#!/usr/bin/env python3
"""Device ms of one tick of the in-program yadif ring route with a
checkout's kernels, on one GPU.

Run from the repository root, once per checkout to compare (in turns:
parent, change, change, parent; unpack the parent as for
tools/compare_parent.py):

    python3 tools/ring_route_ms.py build/parent
    python3 tools/ring_route_ms.py .

One 1080i50 channel of the default load on the ring route
(chip_smoke.interlaced_spec(deinterlace=True): 8 seeded random 3-channel
1920x1080 rings, 4 dissolve layers): a tick's launches (8 yadif_ring + 1
packed_composite) captured into a CUDA graph and replayed
(chip_smoke.device_ms), at parity 0 and 1.  Prints one JSON line with
the card's name and power limit.
"""
import json
import os
import sys

tree = os.path.abspath(sys.argv[1])
sys.path.insert(0, tree)
os.chdir(tree)
import numpy as np
import torch

import chip_smoke as cs
from phaneron_tpu_torch.graph.convert import to_tensor
from phaneron_tpu_torch.graph.pipeline import make_channel_program
from phaneron_tpu_torch.ops.geometry import transform_matrix

dev = torch.device("cuda", 0)
rng = np.random.default_rng(cs.SEED)
W, H = cs.W, cs.H
rings = [[torch.from_numpy(rng.random((3, H, W), dtype=np.float32)).to(dev) for _ in range(3)] for _ in range(8)]
mats = [to_tensor(transform_matrix(W, H, scale_x=0.9, scale_y=0.9, offset_x=0.02 + 0.003 * i), dev) for i in range(4)]
mixes = [torch.tensor(0.2 + 0.1 * i, device=dev) for i in range(4)]
prog = make_channel_program(cs.interlaced_spec(deinterlace=True))
out = {}
for parity in (0, 1):
    par = torch.tensor(parity, dtype=torch.int32, device=dev)
    params = {"layers": [{"src_ring": tuple(rings[2 * i]), "src_b_ring": tuple(rings[2 * i + 1]), "parity": par,
                          "matrix": mats[i], "mix": mixes[i]} for i in range(4)]}
    out[parity] = cs.device_ms(torch, lambda: prog(params), batches=7, calls=4)
print(json.dumps({"tree": sys.argv[1], "ring_route_tick_device_ms": out, "card": cs.card_line()}))
