"""The benchmark's side of the program's interface: the program's
configuration, built from the configuration file, and the program's
parameter tree, filled with the benchmark's raw weights.

The configuration file's ``port`` entry names the program's registry id
(``arch``), which of the file's keys gives each field of the program's
``ArchConfig`` (``fields``; a dotted field is one of a nested group, such
as ``ssm.d_state``) and fields set outright (``set``). The result is a
``dataclasses.replace`` of the registry's configuration, so that nothing
of the program changes.

The parameters are the program's own tree (``Model.abstract_params``
after ``compute_params``, which gives each leaf's served dtype), each leaf
taken from the raw weights by the names in ``chipbench/portmap/<kind>.json``
(``model.json`` for the leaves outside the layers). A leaf of another shape
or dtype, a leaf with no raw weight and a raw weight with no leaf each
raise, so that both sides hold the same weights.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

from chipbench.reference import model as ref_model

PORTMAP = Path(__file__).resolve().parent / "portmap"


def arch_config(c: dict):
    from repro_torch.configs import get_config

    base = get_config(c["port"]["arch"])
    flat, groups = {}, {}
    for field, key in c["port"].get("fields", {}).items():
        head, _, sub = field.partition(".")
        if sub:
            groups.setdefault(head, {})[sub] = c[key]
        else:
            flat[field] = c[key]
    for head, sub in groups.items():
        flat[head] = dataclasses.replace(getattr(base, head), **sub)
    flat.update(c["port"].get("set", {}))
    return dataclasses.replace(base, **flat)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def _put(tree: dict, path: str, value) -> None:
    keys = path.split("/")
    for k in keys[:-1]:
        tree = tree.setdefault(k, {})
    tree[keys[-1]] = value


def _take(meta, raw, where: str):
    if tuple(meta.shape) != tuple(raw.shape) or meta.dtype != raw.dtype:
        raise ValueError(f"{where}: the program holds {tuple(meta.shape)} "
                         f"{meta.dtype}, the raw weight is {tuple(raw.shape)} "
                         f"{raw.dtype}")
    return raw


def params(model, c: dict, raw: dict) -> dict:
    """The program's parameter tree holding the raw weights (views)."""
    cfg = model.cfg
    tree = model.compute_params(model.abstract_params())
    used = set()
    top = json.loads((PORTMAP / "model.json").read_text())
    out: dict = {}
    for path, meta in _leaves({k: v for k, v in tree.items()
                               if k not in ("scan", "rem")}):
        if path not in top:
            raise ValueError(f"the program's leaf {path} has no raw weight")
        name = top[path]
        _put(out, path, _take(meta, raw["model"][name], path))
        used.add(("model", name))

    kinds = ref_model.layer_kinds(c)
    p = len(cfg.layer_pattern)
    n_scan = len(next(iter(tree["scan"].values()))) if tree["scan"] else 0
    index_in_kind = [kinds[:i].count(k) for i, k in enumerate(kinds)]

    def layer(i: int, kind: str, sub: dict) -> dict:
        if kinds[i] != kind:
            raise ValueError(f"layer {i} is {kind} in the program and "
                             f"{kinds[i]} in the configuration's file")
        names = json.loads((PORTMAP / f"{kind}.json").read_text())
        filled: dict = {}
        for path, meta in _leaves(sub):
            if path not in names:
                raise ValueError(f"the program's leaf {kind}/{path} has no raw weight")
            full = raw["layers"][kind][names[path]][index_in_kind[i]]
            _put(filled, path, _take(meta, full, f"layer {i} {path}"))
            used.add((kind, names[path]))
        return filled

    out["scan"] = {}
    for key, periods in tree["scan"].items():
        i, kind = key.split(":")
        out["scan"][key] = [layer(per * p + int(i), kind, sub)
                            for per, sub in enumerate(periods)]
    out["rem"] = {}
    for key, sub in tree["rem"].items():
        j, kind = key.split(":")
        out["rem"][key] = layer(n_scan * p + int(j), kind, sub)

    unused = ({("model", n) for n in raw["model"]}
              | {(k, n) for k, t in raw["layers"].items() for n in t}) - used
    if unused:
        raise ValueError(f"raw weights the program does not hold: {sorted(unused)}")
    return out
