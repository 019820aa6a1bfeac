"""Shared flags of the command-line entry points (`cli/train.py`,
`cli/test.py`).

Port of `step_tpu/utils/cli.py`:

  * ``--set key=value`` overlays any `StepConfig` field. Values parse as
    Python literals, so ``--set iou_thresholds=(0.4,)`` works, and one
    ``--set`` may carry several pairs, ``--set a=1,b=2``.
  * ``--device cuda|cpu`` picks the device (default the card); it takes the
    place of the JAX package's ``--platform``.
"""

from __future__ import annotations

import ast
import re

# Split one --set payload on the commas that start a new key=value pair, so
# ``--set a=1,b=2`` works while tuple values like ``iou_thresholds=(0.4,)``
# stay whole (their commas are not followed by ``ident=``).
_PAIR_SPLIT = re.compile(r",(?=[A-Za-z_][A-Za-z0-9_\-]*=)")


def add_common_args(parser):
    parser.add_argument(
        "--set", dest="overrides", action="append", default=[],
        metavar="KEY=VALUE", help="StepConfig field override (repeatable)",
    )
    parser.add_argument(
        "--device", default="cuda", choices=("cuda", "cpu"),
        help="where the model runs (default: the card)",
    )
    return parser


def apply_overrides(cfg, overrides):
    """Overlay ``key=value[,key=value...]`` strings onto a StepConfig."""
    over = parse_overrides(cfg, overrides)
    return cfg.replace(**over) if over else cfg


def parse_overrides(cfg, overrides) -> dict:
    """Parse ``key=value[,key=value...]`` strings into a typed dict.

    Values are parsed as Python literals. A value that stays a string where
    the config field is numeric, boolean or a tuple raises, and so does a
    non-string value for a string field: either would overlay silently and
    misbehave far from the flag.

    Separate from `apply_overrides` so that `--optimized` can see which
    flags the user set (`models/optimize.py::optimize_for_inference_cli`
    lets them win over the serving defaults).
    """
    over = {}
    for item in overrides:
        for pair in _PAIR_SPLIT.split(item):
            key, eq, raw = pair.partition("=")
            if not eq:
                raise ValueError(f"--set expects key=value, got {pair!r}")
            try:
                value = ast.literal_eval(raw)
            except (ValueError, SyntaxError):
                value = raw  # bare strings (e.g. backbone_depth=tiny)
            key = key.replace("-", "_")
            current = getattr(cfg, key, None)
            if (isinstance(value, str)
                    and current is not None
                    and not isinstance(current, str)):
                raise ValueError(
                    f"--set {key}={raw!r} parsed as a string but the config "
                    f"field is {type(current).__name__} ({current!r})")
            if isinstance(current, str) and not isinstance(value, str):
                raise ValueError(
                    f"--set {key}={raw!r} parsed as "
                    f"{type(value).__name__} but the config field is a "
                    f"string ({current!r})")
            over[key] = value
    return over
