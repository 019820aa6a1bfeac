"""The I3D backbone of STEP's detector, the stem to Mixed_4f, in float32
PyTorch: Conv3d_1a 7x7x7 stride 2, MaxPool_2a, Conv3d_2b and 2c,
MaxPool_3a, Mixed_3b and 3c, MaxPool_4a, Mixed_4b to 4f (at
`backbone_depth` "tiny": Conv3d_1a 3x7x7, MaxPool_2a, one Inception block,
MaxPool_4a, one more). Spatial stride 16 (8 when tiny), T' = ceil(T / 4).

One backbone of the reference, found by `cfg.backbone` under the contract
that `reference/detector.py` states.
"""

from __future__ import annotations

from benchmark.reference import inception as units

STEM = "features.stem_rgb"
STEM_BLOCKS = ("Mixed_3b", "Mixed_3c", "Mixed_4b", "Mixed_4c", "Mixed_4d", "Mixed_4e",
               "Mixed_4f")


def stem_blocks(cfg):
    """(name, channels) of the stem's Inception blocks at the configured depth."""
    if cfg.backbone_depth == "tiny":
        return (("Mixed_3b", units.TINY_A), ("Mixed_4f", units.TINY_B))
    return tuple((n, units.INCEPTION_CHANNELS[n]) for n in STEM_BLOCKS)


def out_channels(cfg) -> int:
    return units.block_out(stem_blocks(cfg)[-1][1])


def parameter_shapes(cfg) -> dict:
    tiny = cfg.backbone_depth == "tiny"
    first = 16 if tiny else 64
    out = units.unit_shapes(f"{STEM}.Conv3d_1a_7x7", 3, first,
                            (3, 7, 7) if tiny else (7, 7, 7))
    cin = first
    if not tiny:
        out.update(units.unit_shapes(f"{STEM}.Conv3d_2b_1x1", 64, 64, (1, 1, 1)))
        out.update(units.unit_shapes(f"{STEM}.Conv3d_2c_3x3", 64, 192, (3, 3, 3)))
        cin = 192
    for name, c in stem_blocks(cfg):
        shapes, cin = units.block_shapes(f"{STEM}.{name}", cin, c)
        out.update(shapes)
    return out


def forward(P, cfg, x, run):
    x = x.permute(0, 4, 1, 2, 3)
    x = units.unit(x, P, f"{STEM}.Conv3d_1a_7x7", (2, 2, 2), run)
    x = units.max_pool(x, (1, 3, 3), (1, 2, 2), run)
    if cfg.backbone_depth == "tiny":
        x = units.inception(x, P, f"{STEM}.Mixed_3b", run)
        x = units.max_pool(x, (3, 3, 3), (2, 2, 2), run)
        return units.inception(x, P, f"{STEM}.Mixed_4f", run).permute(0, 2, 3, 4, 1)
    x = units.unit(x, P, f"{STEM}.Conv3d_2b_1x1", (1, 1, 1), run)
    x = units.unit(x, P, f"{STEM}.Conv3d_2c_3x3", (1, 1, 1), run)
    x = units.max_pool(x, (1, 3, 3), (1, 2, 2), run)
    x = units.inception(units.inception(x, P, f"{STEM}.Mixed_3b", run), P,
                        f"{STEM}.Mixed_3c", run)
    x = units.max_pool(x, (3, 3, 3), (2, 2, 2), run)
    for name in STEM_BLOCKS[2:]:
        x = units.inception(x, P, f"{STEM}.{name}", run)
    return x.permute(0, 2, 3, 4, 1)
