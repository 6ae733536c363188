"""Problem zoo — the reference's ``examples/`` loaded into the package
(QuadraticProgramNetworks.jl:29-31), plus accelerator-scale stress configs.

``setup(name, **kwargs)`` mirrors the reference's ``setup(::Val{name})``
convention (programs.jl:139-141)."""

from __future__ import annotations

from typing import Callable, Dict

_REGISTRY: Dict[str, Callable] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def setup(name, **kwargs):
    name = str(name).lstrip(":")
    if name not in _REGISTRY:
        raise KeyError(f"Unknown example {name!r}. "
                       f"Available: {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)


from . import simple_bilevel          # noqa: E402,F401
from . import robust_avoid_simple     # noqa: E402,F401
from . import four_player_matrix_game # noqa: E402,F401
from . import robust_avoid            # noqa: E402,F401
from . import deep_synthetic          # noqa: E402,F401
from . import rock_paper_scissors     # noqa: E402,F401
from . import toll_setting            # noqa: E402,F401
from . import chainstore              # noqa: E402,F401
from . import trilevel_escape         # noqa: E402,F401
from . import shepherd_sheep          # noqa: E402,F401
from . import robust_constrained      # noqa: E402,F401
from . import small_deprecated        # noqa: E402,F401
from . import control_avoid           # noqa: E402,F401
from . import interpolation_avoid     # noqa: E402,F401

__all__ = ["setup", "register"]
