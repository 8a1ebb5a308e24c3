"""Trees of tensors: the few ``jax.tree`` functions the port needs.

A tree is a nested dict, tuple, list or NamedTuple whose leaves are
tensors (or arrays, or numbers); ``None`` is an empty subtree, as in JAX.
Leaves are visited in JAX's flatten order (dict keys sorted, sequences and
NamedTuple fields in order), and ``leaves_with_path`` names each leaf as
``jax.tree_util.keystr`` does (``.params['layers']['attn']['wq']``,
``.opt.step``, ``[0]``), so a leaf list lines up with the JAX package's.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree: Any) -> Iterator[Tuple[str, Any]]:
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield f"[{k!r}]", tree[k]
    elif _is_namedtuple(tree):
        for f in tree._fields:
            yield f".{f}", getattr(tree, f)
    else:
        for i, v in enumerate(tree):
            yield f"[{i}]", v


def _is_node(tree: Any) -> bool:
    return isinstance(tree, (dict, tuple, list))


def leaves_with_path(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(keystr, leaf) pairs in JAX's flatten order."""
    if tree is None:
        return []
    if not _is_node(tree):
        return [(prefix, tree)]
    out: List[Tuple[str, Any]] = []
    for key, child in _children(tree):
        out.extend(leaves_with_path(child, prefix + key))
    return out


def leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in leaves_with_path(tree)]


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure); the result has the structure
    of ``tree``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if _is_node(tree):
        mapped = [tree_map(fn, v, *(r[i] for r in rest))
                  for i, v in enumerate(tree)]
        if _is_namedtuple(tree):
            return type(tree)(*mapped)
        return type(tree)(mapped)
    return fn(tree, *rest)


def unflatten_like(tree: Any, new_leaves: List[Any]) -> Any:
    """``tree``'s structure with ``new_leaves`` (in flatten order) as its
    leaves."""
    paths = [path for path, _ in leaves_with_path(tree)]
    if len(paths) != len(new_leaves):
        raise ValueError(f"{len(new_leaves)} leaves for a tree of "
                         f"{len(paths)}")
    return _rebuild(tree, "", dict(zip(paths, new_leaves)))


def _rebuild(tree: Any, prefix: str, slot: dict) -> Any:
    if tree is None:
        return None
    if not _is_node(tree):
        return slot[prefix]
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], prefix + f"[{k!r}]", slot)
                for k in tree}
    mapped = [_rebuild(v, prefix + key, slot)
              for key, v in _children(tree)]
    if _is_namedtuple(tree):
        return type(tree)(*mapped)
    return type(tree)(mapped)


def tree_map_n(fn: Callable[..., Tuple[Any, ...]], n: int, tree: Any,
               *rest: Any) -> Tuple[Any, ...]:
    """Like ``tree_map`` for an ``fn`` that returns an ``n``-tuple: ``n``
    trees of ``tree``'s structure, the i-th holding item i of each
    result."""
    outs = [fn(*ls) for ls in zip(leaves(tree), *(leaves(r) for r in rest))]
    return tuple(unflatten_like(tree, [o[i] for o in outs])
                 for i in range(n))
