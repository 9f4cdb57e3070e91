"""Path-based parameter / input sharding rules, MaxText-style logical axes
(the port of the reference package's ``sharding/rules.py``).

Every rule maps a parameter path suffix to an ordered list of *candidate*
logical specs; ``resolve_spec`` applies divisibility fallbacks per mesh, and
we pick the candidate that keeps the most dims sharded.  This single table
covers all ten assigned architectures (dense / MoE / MLA / Mamba / RWKV) on
both the single-pod (data, model) and multi-pod (pod, data, model) meshes.

A path is the leaf's dict keys and list indices joined by ``/``
(``stages/0/layers/3/mixer/wq``), as the reference's
``keystr(simple=True, separator="/")`` renders them.  The reference
stacks a stage's layers (and caches) on a leading ``repeats`` dim, which
its specs mark with a leading None; the port holds one tensor a layer,
so a port leaf's spec is the reference's without that None.

``param_shardings`` and ``input_shardings`` turn specs into
``torch.distributed.tensor`` placements, one per mesh axis (``Shard(d)``
where the spec puts that axis on dim ``d``, else ``Replicate()``).  No
model path of the port applies them yet: a model runs on one device.
"""
from __future__ import annotations

import re
from typing import Optional

from .context import Mesh, PartitionSpec as P, active_mesh, resolve_spec

# (regex on /-joined path, [candidate logical specs for the unstacked rank])
PARAM_RULES = [
    (r"(^|/)embed/table$", [("tensor", "fsdp"), (None, "fsdp")]),
    (r"(^|/)frontend/w$", [("fsdp", "tensor")]),
    (r"(^|/)unembed/w$", [("fsdp", "tensor")]),
    (r"(^|/)(wq|wk|wv|wq_b|wk_b|wv_b|wi_gate|wi_up|in_proj|wr6|wk6|wv6|wg6)$",
     [("fsdp", "tensor")]),
    (r"(^|/)(wq_a|wkv_a)$", [("fsdp", "tensor"), ("fsdp", None)]),
    (r"(^|/)(wo|out_proj|wo6)$", [("tensor", "fsdp")]),
    (r"(^|/)router/w$", [(None, None)]),
    (r"(^|/)experts/(w_gate|w_up)$",
     [("expert", "fsdp", None), (None, "fsdp", "tensor")]),
    (r"(^|/)experts/w_down$",
     [("expert", None, "fsdp"), (None, "tensor", "fsdp")]),
    # mamba
    (r"(^|/)conv_w$", [(None, "tensor")]),
    (r"(^|/)(conv_b|dt_b|Dskip)$", [("tensor",)]),
    (r"(^|/)x_proj$", [("tensor", None)]),
    (r"(^|/)dt_w$", [(None, "tensor")]),
    (r"(^|/)A_log$", [("tensor", None)]),
    # rwkv loras / mixes
    (r"(^|/)lora_w1$", [("fsdp", None)]),
    (r"(^|/)lora_w2$", [(None, "tensor")]),
    (r"(^|/)(w0|u|mu_.*)$", [(None,) * 8]),  # trimmed to rank below
    (r"scale$", [(None,)]),
]

INPUT_RULES = [
    (r"(^|/)(tokens|labels|loss_mask|frame_labels|frame_mask|positions)$",
     [("batch", None)]),
    (r"(^|/)(features|image_embeds)$", [("batch", None, None)]),
    (r"(^|/)(k|v)$", [("batch", "kv_len", "tensor", None)]),
    (r"(^|/)(ckv|kpe)$", [("batch", "kv_len", None)]),
    (r"(^|/)conv$", [("batch", None, "tensor")]),
    (r"(^|/)ssm$", [("batch", "tensor", None)]),
    (r"(^|/)wkv$", [("batch", None, None, None)]),
    (r"(^|/)(tm_shift|cm_shift)$", [("batch", None)]),
]


def _match(path: str, rules) -> Optional[list]:
    for pat, cands in rules:
        if re.search(pat, path):
            return cands
    return None


def _pick(cands, shape, mesh: Mesh) -> P:
    best, best_n = P(*([None] * len(shape))), -1
    for cand in cands:
        cand = tuple(cand)[: len(shape)]
        cand = cand + (None,) * (len(shape) - len(cand))
        spec = resolve_spec(cand, shape, mesh)
        n = sum(e is not None for e in spec)
        if n > best_n:
            best, best_n = spec, n
    return best


def _spec_for(path_str: str, leaf, mesh: Mesh, rules) -> P:
    shape = tuple(leaf.shape)
    cands = _match(path_str, rules)
    if cands is None:
        return P(*([None] * len(shape)))
    return _pick(cands, shape, mesh)


def tree_map_with_path(fn, tree, *rest, path=""):
    """``fn(path, leaf, *rest_leaves)`` over a tree of dicts and lists
    (and the same places of each tree in ``rest``), keeping its
    structure; ``path`` is the keys and indices joined by ``/``."""
    join = (lambda k: f"{path}/{k}") if path else str
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, *(r[k] for r in rest),
                                      path=join(k))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map_with_path(fn, v, *(r[i] for r in rest),
                                   path=join(i))
                for i, v in enumerate(tree)]
    return fn(path, tree, *rest)


def param_specs(params, mesh: Mesh):
    return tree_map_with_path(
        lambda path, x: _spec_for(path, x, mesh, PARAM_RULES), params)


def batch_spec(inputs, mesh: Mesh):
    def leaf(path, x):
        if not hasattr(x, "shape") or x.ndim == 0:
            return P()
        cands = _match(path, INPUT_RULES)
        if cands is None:
            # default: shard the leading (batch) dim
            cand = ("batch",) + (None,) * (x.ndim - 1)
            return _pick([cand], tuple(x.shape), mesh)
        return _pick(cands, tuple(x.shape), mesh)
    return tree_map_with_path(leaf, inputs)


def placements(spec: P, mesh: Mesh):
    """One ``torch.distributed.tensor`` placement per mesh axis:
    ``Shard(d)`` where ``spec`` puts the axis on dim ``d``, else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    dim_of = {}
    for d, entry in enumerate(spec):
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a is not None:
                dim_of[a] = d
    return tuple(Shard(dim_of[a]) if a in dim_of else Replicate()
                 for a in mesh.axis_names)


def param_shardings(params, mesh: Mesh):
    return tree_map_with_path(lambda _, s: placements(s, mesh),
                              param_specs(params, mesh))


def input_shardings(inputs, mesh: Mesh):
    return tree_map_with_path(lambda _, s: placements(s, mesh),
                              batch_spec(inputs, mesh))


def constrain_like_params(tree):
    """Pin a tree (e.g. grads) to the parameter sharding rules inside the
    active mesh context.  The specs are resolved as the reference
    resolves them; the tensors come back unchanged, because eager
    PyTorch has no partitioner to steer (``context.constrain``)."""
    mesh = active_mesh()
    if mesh is None:
        return tree
    param_specs(tree, mesh)
    return tree


def sharded_bytes(tree, specs, mesh: Mesh) -> int:
    """The bytes one device holds of ``tree`` laid out by ``specs``: each
    leaf's bytes over the product of the mesh axes its spec shards it
    on (a leaf without a shape, like an int, holds none)."""
    sizes = mesh.shape
    per_leaf = []

    def leaf(_, x, spec):
        if not hasattr(x, "shape"):
            return
        n = x.numel() * x.element_size()
        div = 1
        for entry in spec:
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                if a is not None:
                    div *= sizes[a]
        if n % div:
            raise ValueError(f"{tuple(x.shape)} does not split by {spec}")
        per_leaf.append(n // div)
    tree_map_with_path(leaf, tree, specs)
    return sum(per_leaf)
