"""Lowering knobs as per-model configuration.

A copy of the reference package's ``Lowering`` (``ops/lowering.py``): a
frozen dataclass carried on the model config (``ModelConfig.lowering``),
built from a config dict by ``from_dict`` (unknown keys raise ``WRONG
ARG``, values are validated), with the ``SGT_*`` environment variables
overlaid by ``resolve`` (precedence: environment > config > default).
The Trainer writes the resolved dict into the run's config snapshot.

What each knob does in this port:

- ``max_shift``: the temporal tap radius of the reference lowerings.
  The kernels read the two frames of a shift at any offset, so the
  radius changes no arithmetic here; it is the bound of every shift
  range check (load, save, eval, artifacts), which raises once |ypos|
  reaches ``max_shift - 0.5``.
- ``exact_xpos``: run the 3-tap joint-axis (xpos) interpolation pass
  before each temporal shift (``ops/temporal_shift.py`` ``joint_pass``)
  instead of treating xpos as exactly zero.  The reference's Pallas path
  refuses this knob and falls back to its conv lowering; here the
  kernels keep running on the joint-passed input.
- ``bn_lp`` / ``bn_lp_eval``: normalize low-precision activations as
  ``x * a + b`` in their own dtype (coefficients derived in fp32) in
  training / in eval, instead of the fp32 normalize
  (``ops/batchnorm.py``).  No effect on fp32 activations.
- ``tshift_impl``, ``sgcn_impl``, ``sshift_impl``: choose among the
  reference package's XLA formulations of the temporal shift, the
  spatial transform and the standalone spatial shift.  The hand-written
  kernels replace all of them, so these are validated and recorded, and
  select nothing.
- ``tcn_fuse``, ``tcn_freq_fuse``, ``tcn_bnfold``: fusion passes of the
  reference's XLA lowerings (shift + 1x1 conv as one conv or one
  frequency-domain pass, BN folded into the 1x1 weights).  They compute
  the same function as the unfused composition; validated and recorded,
  they select nothing here.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional

_TSHIFT_IMPLS = ("conv", "slice", "roll", "matmul", "dft", "pallas")
_SGCN_IMPLS = ("chain", "circconv", "dft")
_SSHIFT_IMPLS = ("gather", "roll", "onehot")
_FREQ_FUSE = ("0", "1", "eval")


@dataclasses.dataclass(frozen=True)
class Lowering:
    tshift_impl: str = "dft"
    sgcn_impl: str = "dft"
    sshift_impl: str = "gather"
    tcn_fuse: bool = False
    tcn_freq_fuse: str = "eval"
    tcn_bnfold: bool = False
    bn_lp: bool = False
    bn_lp_eval: bool = True
    max_shift: int = 8
    exact_xpos: bool = False

    def __post_init__(self) -> None:
        self.validate()

    @property
    def xpos_zero(self) -> bool:
        """True when the joint-axis (xpos) pass is the identity."""
        return not self.exact_xpos

    def validate(self) -> "Lowering":
        for val, allowed, name in (
                (self.tshift_impl, _TSHIFT_IMPLS, "tshift_impl"),
                (self.sgcn_impl, _SGCN_IMPLS, "sgcn_impl"),
                (self.sshift_impl, _SSHIFT_IMPLS, "sshift_impl"),
                (str(self.tcn_freq_fuse), _FREQ_FUSE, "tcn_freq_fuse")):
            if val not in allowed:
                raise ValueError(
                    f"lowering.{name}={val!r}: must be one of {allowed}")
        if self.max_shift < 1:
            raise ValueError(
                f"lowering.max_shift={self.max_shift}: must be >= 1")
        return self


def _b01(raw: str) -> bool:          # "1" enables
    return raw == "1"


def _bnot0(raw: str) -> bool:        # anything but "0" enables
    return raw != "0"


# field -> (environment variable, parser), the reference package's
_ENV = {
    "tshift_impl": ("SGT_TSHIFT_IMPL", str),
    "sgcn_impl": ("SGT_SGCN_IMPL", str),
    "sshift_impl": ("SGT_SSHIFT_IMPL", str),
    "tcn_fuse": ("SGT_TCN_FUSE", _b01),
    "tcn_freq_fuse": ("SGT_TCN_FREQ_FUSE", str),
    "tcn_bnfold": ("SGT_TCN_BNFOLD", _b01),
    "bn_lp": ("SGT_BN_LP", _b01),
    "bn_lp_eval": ("SGT_BN_LP_EVAL", _bnot0),
    "max_shift": ("SGT_MAX_SHIFT", int),
    "exact_xpos": ("SGT_EXACT_XPOS", _b01),
}

_TRUE = {"1", "true", "yes", "on"}
_FALSE = {"0", "false", "no", "off"}


def from_dict(d: Optional[Dict[str, Any]]) -> Lowering:
    """A Lowering from a config dict; unknown keys raise KeyError (the
    experiment config's WRONG ARG contract), bad values ValueError.
    Boolean fields take YAML booleans or the strings true/false, yes/no,
    on/off, 1/0."""
    d = dict(d or {})
    valid = {f.name for f in dataclasses.fields(Lowering)}
    unknown = set(d) - valid
    if unknown:
        raise KeyError(
            f"WRONG ARG in lowering config: {sorted(unknown)}; "
            f"valid keys: {sorted(valid)}")
    coerced = {}
    for k, v in d.items():
        default = getattr(Lowering(), k)
        if isinstance(default, bool):
            if isinstance(v, str):
                lv = v.strip().lower()
                if lv in _TRUE:
                    v = True
                elif lv in _FALSE:
                    v = False
                else:
                    raise ValueError(
                        f"lowering.{k}={v!r}: not a boolean "
                        f"(use true/false)")
            coerced[k] = bool(v)
        elif isinstance(default, int):
            coerced[k] = int(v)
        else:
            coerced[k] = str(v)
    return Lowering(**coerced)


def env_overrides() -> Dict[str, Any]:
    """The fields set by ``SGT_*`` environment variables (only the
    variables that are set appear)."""
    out: Dict[str, Any] = {}
    for field, (var, parse) in _ENV.items():
        raw = os.environ.get(var)
        if raw is not None:
            out[field] = parse(raw)
    return out


def resolve(base: Optional[Lowering] = None) -> Lowering:
    """``base`` (or the defaults) with the set ``SGT_*`` variables
    overlaid: environment > config > default."""
    overrides = env_overrides()
    base = base or Lowering()
    if not overrides:
        return base
    return dataclasses.replace(base, **overrides)


def as_dict(low: Lowering) -> Dict[str, Any]:
    return dataclasses.asdict(low)
