"""Pretrained weights: torch I3D checkpoints → this package's state_dicts.

Port of `step_tpu/models/convert.py`. The public Kinetics I3D checkpoints
are torch state_dicts, and so are this package's models, so the conversion
is a renaming: conv weights stay OIDHW, and no kernel is transposed.

  * `normalize_i3d_state_dict` maps the four namings the JAX package knows
    (piergiaj/pytorch-i3d, hassony2/kinetics_i3d_pytorch, and the nested
    and flat namings of its from-spec oracle; a DataParallel `module.`
    prefix is stripped) onto one canonical flat naming,
    `{Layer}.{branch}.conv3d.*` / `{Layer}.{branch}.batch3d.*`, with a
    dry-run report (`scheme`, `mapped`, `missing`, `ignored`);
  * `convert_torch_i3d` gives the state_dict of `models/i3d.py::
    I3DClassifier` (`stem.*`, `tail.*`, `logits.*`);
  * `load_i3d_into_detector` splits it at the reference's cut: the stem
    (through Mixed_4f) goes to `features.stem_rgb` and, for a two-stream
    detector, to `features.stem_flow` with its first conv inflated from
    RGB to flow (`inflate_rgb_to_flow`); the tail (Mixed_5b/5c) to every
    refinement step's `steps.{s}.tail`;
  * `load_torch_checkpoint` reads a `.pt`/`.pth` file and
    `pretrained_detector_variables` does all of it in one call, as
    `fit(pretrained_i3d=...)` and `cli/train.py --pretrained-i3d` use it.
"""

from __future__ import annotations

from typing import Dict

import torch

_STEM_LAYERS = [
    "Conv3d_1a_7x7", "Conv3d_2b_1x1", "Conv3d_2c_3x3",
    "Mixed_3b", "Mixed_3c",
    "Mixed_4b", "Mixed_4c", "Mixed_4d", "Mixed_4e", "Mixed_4f",
]
_TAIL_LAYERS = ["Mixed_5b", "Mixed_5c"]

# our branch name → source module path per scheme (relative to the block)
_SCHEME_BRANCHES = {
    "piergiaj": {
        "b0": "b0", "b1a": "b1a", "b1b": "b1b",
        "b2a": "b2a", "b2b": "b2b", "b3b": "b3b",
    },
    "hassony2": {
        "b0": "branch_0", "b1a": "branch_1.0", "b1b": "branch_1.1",
        "b2a": "branch_2.0", "b2b": "branch_2.1", "b3b": "branch_3.1",
    },
    "nested": {
        "b0": "branch_0.conv3d_0a_1x1",
        "b1a": "branch_1.conv3d_0a_1x1", "b1b": "branch_1.conv3d_0b_3x3",
        "b2a": "branch_2.conv3d_0a_1x1", "b2b": "branch_2.conv3d_0b_3x3",
        "b3b": "branch_3.conv3d_0b_1x1",
    },
    "flat": {
        "b0": "b0", "b1a": "b1a", "b1b": "b1b",
        "b2a": "b2a", "b2b": "b2b", "b3b": "b3b",
    },
}
# scheme → (layer-name transform, BN module name, logits prefix)
_SCHEME_STYLE = {
    "piergiaj": (lambda n: n, "bn", "logits"),
    "hassony2": (lambda n: n.lower(), "batch3d", "conv3d_0c_1x1"),
    "nested": (lambda n: n, "batch3d", "logits"),
    "flat": (lambda n: n, "batch3d", "logits"),
}
_BN = ("weight", "bias", "running_mean", "running_var")


def _detect_scheme(sd) -> str:
    if "conv3d_1a_7x7.conv3d.weight" in sd:
        return "hassony2"
    if "Mixed_3b.branch_0.conv3d_0a_1x1.conv3d.weight" in sd:
        return "nested"
    if "Mixed_3b.b0.bn.weight" in sd:
        return "piergiaj"
    if "Mixed_3b.b0.batch3d.weight" in sd:
        return "flat"
    raise KeyError(
        "unrecognized I3D state_dict naming: found none of the known "
        "signature keys (hassony2 'conv3d_1a_7x7...', nested "
        "'Mixed_3b.branch_0.conv3d_0a_1x1...', piergiaj 'Mixed_3b.b0.bn...', "
        f"flat 'Mixed_3b.b0.batch3d...'); sample keys: {sorted(sd)[:5]}")


def normalize_i3d_state_dict(sd, scheme: str | None = None):
    """Map any known torch-I3D checkpoint naming onto the canonical flat
    naming `convert_torch_i3d` reads → (canonical_sd, report); `report`
    holds `scheme`, `mapped` ({source key: canonical key}), `missing`
    (expected source keys absent) and `ignored` (source keys not consumed,
    such as `num_batches_tracked`): the dry run of a load."""
    sd = {k[len("module."):] if k.startswith("module.") else k: v
          for k, v in sd.items()}
    if scheme is None:
        scheme = _detect_scheme(sd)
    layer_name, bn_name, logits_prefix = _SCHEME_STYLE[scheme]
    branches = _SCHEME_BRANCHES[scheme]

    out: Dict[str, object] = {}
    mapped: Dict[str, str] = {}
    missing = []

    def take(src: str, dst: str, required: bool = True):
        if src in sd:
            out[dst] = sd[src]
            mapped[src] = dst
        elif required:
            missing.append(src)

    def unit(src_prefix: str, dst_prefix: str):
        take(f"{src_prefix}.conv3d.weight", f"{dst_prefix}.conv3d.weight")
        take(f"{src_prefix}.conv3d.bias", f"{dst_prefix}.conv3d.bias", required=False)
        has_bn = f"{src_prefix}.{bn_name}.weight" in sd
        for name in _BN:
            take(f"{src_prefix}.{bn_name}.{name}", f"{dst_prefix}.batch3d.{name}",
                 required=has_bn)

    for name in _STEM_LAYERS + _TAIL_LAYERS:
        src_layer = layer_name(name)
        if name.startswith("Conv3d"):
            unit(src_layer, name)
        else:
            for ours, theirs in branches.items():
                unit(f"{src_layer}.{theirs}", f"{name}.{ours}")
    # the classifier (optional: a detection fine-tune drops it)
    take(f"{logits_prefix}.conv3d.weight", "logits.conv3d.weight", required=False)
    take(f"{logits_prefix}.conv3d.bias", "logits.conv3d.bias", required=False)

    ignored = sorted(set(sd) - set(mapped))
    report = {"scheme": scheme, "mapped": mapped, "missing": missing,
              "ignored": ignored}
    return out, report


def _tensor(v) -> torch.Tensor:
    return torch.as_tensor(v).detach().to(device="cpu", dtype=torch.float32)


def convert_torch_i3d(sd, include_logits: bool = True) -> Dict[str, torch.Tensor]:
    """A torch I3D state_dict (tensors or numpy arrays, any naming
    `normalize_i3d_state_dict` recognizes) → the float32 state_dict of
    `I3DClassifier` (`stem.*`, `tail.*`, and `logits.*` with
    `include_logits` where the checkpoint has a classifier). Raises
    KeyError with the normalizer's missing keys if the checkpoint is
    incomplete. A bias-less classifier conv gets a zero bias, since
    `I3DClassifier.logits` has one."""
    sd, report = normalize_i3d_state_dict(sd)
    if report["missing"]:
        raise KeyError(
            f"I3D checkpoint (scheme={report['scheme']!r}) is missing "
            f"{len(report['missing'])} expected keys, e.g. {report['missing'][:5]}")
    out: Dict[str, torch.Tensor] = {}
    for part, layers in (("stem", _STEM_LAYERS), ("tail", _TAIL_LAYERS)):
        for key, value in sd.items():
            layer, rest = key.split(".", 1)
            if layer not in layers:
                continue
            rest = rest.replace("conv3d.", "conv.").replace("batch3d.", "bn.")
            out[f"{part}.{layer}.{rest}"] = _tensor(value)
    if include_logits and "logits.conv3d.weight" in sd:
        weight = _tensor(sd["logits.conv3d.weight"])
        bias = sd.get("logits.conv3d.bias")
        out["logits.weight"] = weight
        out["logits.bias"] = (_tensor(bias) if bias is not None
                              else torch.zeros(weight.shape[0]))
    return out


def inflate_rgb_to_flow(weight: torch.Tensor, in_channels: int = 2) -> torch.Tensor:
    """First-conv inflation of an OIDHW kernel: the mean over the RGB input
    channels, repeated `in_channels` times and scaled by 3 / in_channels, so
    a constant input keeps its response. The mean is the sum times the
    float32 reciprocal of the count, as XLA computes `jnp.mean`."""
    mean = weight.sum(dim=1, keepdim=True) * (1.0 / weight.shape[1])
    return mean.repeat(1, in_channels, 1, 1, 1) * (3.0 / in_channels)


def load_i3d_into_detector(detector_sd: Dict[str, torch.Tensor],
                           i3d_sd: Dict[str, torch.Tensor], cfg,
                           strict: bool = True) -> Dict[str, torch.Tensor]:
    """A detector state_dict with `convert_torch_i3d`'s weights in it (a new
    dict; the inputs are not changed): the stem in `features.stem_rgb` (and
    an inflated copy in `features.stem_flow` for `cfg.two_stream`), the tail
    in each `steps.{s}.tail`. With `strict`, every loaded tensor must land
    on a tensor of the same shape, and every tensor of those subtrees must
    be loaded, else ValueError: a tiny or BN-folded detector cannot take a
    full I3D."""
    out = dict(detector_sd)
    loaded = {}
    targets = [("stem.", "features.stem_rgb.")]
    if cfg.two_stream:
        targets.append(("stem.", "features.stem_flow."))
    targets += [("tail.", f"steps.{s}.tail.") for s in range(cfg.num_steps)]
    for src, dst in targets:
        for key, value in i3d_sd.items():
            if not key.startswith(src):
                continue
            name = dst + key[len(src):]
            if dst == "features.stem_flow." and name.endswith("Conv3d_1a_7x7.conv.weight"):
                value = inflate_rgb_to_flow(value)
            loaded[name] = value.clone()
    if strict:
        subtrees = tuple(dst for _, dst in targets)
        mine = {k for k in detector_sd if k.startswith(subtrees)}
        if mine != set(loaded):
            raise ValueError(
                f"the I3D checkpoint does not fit this detector: "
                f"{len(set(loaded) - mine)} tensors with no place, e.g. "
                f"{sorted(set(loaded) - mine)[:3]}; {len(mine - set(loaded))} "
                f"left unloaded, e.g. {sorted(mine - set(loaded))[:3]}")
        for name, value in loaded.items():
            if tuple(detector_sd[name].shape) != tuple(value.shape):
                raise ValueError(f"{name}: the checkpoint's shape {tuple(value.shape)}, "
                                 f"the detector's {tuple(detector_sd[name].shape)}")
    out.update(loaded)
    return out


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A .pt/.pth file → a flat {key: tensor} state_dict, unwrapped from the
    containers public releases ship ({'state_dict': ...}, {'model': ...},
    {'net': ...}, a bare OrderedDict); entries that are not tensors are
    dropped. The naming is normalized downstream."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    for key in ("state_dict", "model", "net"):
        if isinstance(obj, dict) and isinstance(obj.get(key), dict):
            obj = obj[key]
    if not isinstance(obj, dict):
        raise ValueError(f"{path}: expected a state-dict-like mapping, got "
                         f"{type(obj).__name__}")
    out = {k: v.detach().cpu() for k, v in obj.items() if torch.is_tensor(v)}
    if not out:
        raise ValueError(f"{path}: no tensors found in checkpoint")
    return out


def pretrained_detector_variables(detector_sd: Dict[str, torch.Tensor], path: str,
                                  cfg, verbose: bool = True) -> Dict[str, torch.Tensor]:
    """A torch I3D checkpoint file → the detector state_dict `detector_sd`
    with the Kinetics backbone loaded (`load_i3d_into_detector`, strict).
    With `verbose` it prints the normalizer's report first, so a file of
    another architecture fails loudly before any training step."""
    sd = load_torch_checkpoint(path)
    _, report = normalize_i3d_state_dict(sd)
    if verbose:
        print(f"pretrained I3D: scheme={report['scheme']!r} "
              f"mapped={len(report['mapped'])} "
              f"missing={len(report['missing'])} "
              f"ignored={len(report['ignored'])}", flush=True)
        if report["missing"]:
            print(f"  missing (first 5): {report['missing'][:5]}", flush=True)
    i3d = convert_torch_i3d(sd, include_logits=False)
    return load_i3d_into_detector(detector_sd, i3d, cfg)
