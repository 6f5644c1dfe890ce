"""A detection config that uses every type of `parse_model`'s vocabulary no
YAML of the repo uses (the 13 of ROADMAP item 17), as one model over three
levels with a `Detect` head: built by `tests/test_torch_vocab.py` against
JAX's graph and by `chip_smoke.py` phase 23 on the card. It has no YAML
file, so a checkpoint of it cannot name its config (build it from this
dict)."""

ITEM_17 = ("C1", "C3x", "C3TR", "C3Ghost", "GhostConv", "GhostBottleneck", "Focus", "DWConv",
           "Conv2", "ConvTranspose", "DWConvTranspose2d", "BottleneckCSP", "RepVGGBlock")

VOCABULARY = {
    "nc": 3,
    "backbone": [
        [-1, 1, "Focus", [16, 3]],                         # 0  /2
        [-1, 1, "GhostConv", [24, 3, 2]],                   # 1  /4
        [-1, 2, "C1", [24]],                                # 2
        [-1, 1, "DWConv", [32, 3, 2, 1, False]],            # 3  /8
        [-1, 1, "Conv2", [32, 3, 1]],                       # 4
        [-1, 2, "C3x", [32]],                               # 5
        [-1, 1, "GhostBottleneck", [48, 3, 2]],             # 6  /16
        [-1, 1, "C3Ghost", [48]],                           # 7
        [-1, 1, "RepVGGBlock", [64, 3, 2]],                 # 8  /32
        [-1, 1, "C3TR", [64]],                              # 9
    ],
    "head": [
        [-1, 1, "ConvTranspose", [48, 2, 2]],               # 10 /16
        [[-1, 7], 1, "Concat", [1]],                        # 11
        [-1, 2, "BottleneckCSP", [48]],                     # 12
        [-1, 1, "DWConvTranspose2d", [48, 2, 2]],           # 13 /8
        [[-1, 5], 1, "Concat", [1]],                        # 14
        [-1, 2, "RepC3", [32]],                             # 15
        [-1, 2, "GhostBottleneck", [32]],                   # 16 (a repeated row)
        [[16, 12, 9], 1, "Detect", ["nc"]],
    ],
}
