"""Model resolution for the default ``-m`` dirs, without JAX.

Counterpart of ``realsr_tpu/modelzoo.py``, with the same search order (the
path as given, the install root, the repo's ``models/`` dir, the user cache)
and the same synthesis of a missing ``x4.bin`` next to a committed
``x4.param``, through this package's synth: the same seeds give the same
bytes as the JAX package (DF2K = 0, DF2K_JPEG = 1).
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional, Tuple

from realsr_tpu_torch.utils.fsutils import install_root

_SYNTH_SEEDS = {"models-DF2K": 0, "models-DF2K_JPEG": 1}


def _cache_dir() -> str:
    return os.environ.get(
        "REALSR_TPU_MODEL_CACHE",
        os.path.join(
            os.environ.get("XDG_CACHE_HOME", os.path.expanduser("~/.cache")),
            "realsr_tpu",
            "models",
        ),
    )


def _candidate_dirs(model: str) -> List[str]:
    """Directories to look for <model>/x*.{param,bin} in, in order."""
    cands = [model]
    if not os.path.isabs(model):
        root = os.path.dirname(install_root())
        cands.append(os.path.join(root, model))
        cands.append(os.path.join(root, "models", model))
    cands.append(os.path.join(_cache_dir(), os.path.basename(model)))
    return cands


def _synth_bin(parampath: str, binpath: str, seed: int) -> None:
    from realsr_tpu_torch.ncnn.bin import write_weights
    from realsr_tpu_torch.ncnn.param import parse_param_file
    from realsr_tpu_torch.ncnn.synth import synth_weights

    graph = parse_param_file(parampath)
    write_weights(graph, synth_weights(graph, seed=seed), binpath)


def _emit_param(parampath: str) -> None:
    from realsr_tpu_torch.models.rrdbnet import RRDBNetSpec
    from realsr_tpu_torch.ncnn.synth import make_rrdbnet_param_text

    with open(parampath, "w", encoding="utf-8") as f:
        f.write(make_rrdbnet_param_text(RRDBNetSpec()))


def resolve_model_files(
    model: str, scale: int = 4, auto_synth: bool = True
) -> Optional[Tuple[str, str]]:
    """Locate (or materialize) ``<model>/x<scale>.{param,bin}``, or a
    SwinIR model's ``<model>/x<scale>.{json,pth}``.

    Returns (parampath, binpath), or None when the model cannot be found
    — and, for the known DF2K dirs with ``auto_synth``, cannot be
    synthesized either. Synthesis prints a one-line stderr notice; it is
    never silent about running on placeholder weights.
    """
    base = os.path.basename(os.path.normpath(model))
    pname, bname = f"x{scale}.param", f"x{scale}.bin"
    jname, tname = f"x{scale}.json", f"x{scale}.pth"

    # first param-bearing dir wins, like the reference's CWD-then-exe-dir
    # resolution (filesystem_utils.h:167-173) — a complete pair further
    # down the chain never shadows an earlier user-provided graph; a dir
    # without a .param but with a SwinIR model's .json and .pth gives those
    incomplete = None
    for d in _candidate_dirs(model):
        if not os.path.isfile(os.path.join(d, pname)):
            if os.path.isfile(os.path.join(d, jname)) and os.path.isfile(os.path.join(d, tname)):
                return (os.path.join(d, jname), os.path.join(d, tname))
            continue
        if os.path.isfile(os.path.join(d, bname)):
            return (os.path.join(d, pname), os.path.join(d, bname))
        incomplete = d
        break

    if not auto_synth or base not in _SYNTH_SEEDS:
        return None
    seed = _SYNTH_SEEDS[base]

    # a dir with the graph but no weights: synthesize next to it if
    # writable, else mirror into the cache
    targets = []
    if incomplete is not None:
        targets.append((incomplete, os.path.join(incomplete, pname)))
    cache = os.path.join(_cache_dir(), base)
    targets.append((cache, os.path.join(incomplete, pname) if incomplete else None))

    for d, src_param in targets:
        try:
            os.makedirs(d, exist_ok=True)
            pp = os.path.join(d, pname)
            if not os.path.isfile(pp):
                if src_param is not None:
                    import shutil

                    shutil.copyfile(src_param, pp)
                else:
                    _emit_param(pp)
            bp = os.path.join(d, bname)
            print(
                f"note: {base} has no {bname} — synthesizing deterministic "
                f"placeholder weights into {d} (the reference snapshot "
                "ships none); drop a real x4.bin there to override "
                "(models/README.md)",
                file=sys.stderr,
            )
            _synth_bin(pp, bp, seed)
            return (pp, bp)
        except OSError:
            continue  # not writable: try the next target
    return None


def ensure_model(model: str, scale: int = 4) -> str:
    """C++-bridge entry: returns ``parampath\\nbinpath`` or raises.

    Called by the port's native CLI before engine init so both CLIs share
    one resolution/synthesis path (realsr_tpu_torch/native/cli/main.cpp
    model check)."""
    r = resolve_model_files(model, scale)
    if r is None:
        raise FileNotFoundError(
            f"model files not found under -m {model} "
            f"(tried {', '.join(_candidate_dirs(model))})"
        )
    return "\n".join(r)
