"""Nested dicts, lists and tuples of tensors: the port's parameter and state trees.

Leaves are ordered as ``jax.tree.leaves`` orders them (dict keys sorted), so
a sum over leaves adds in the JAX package's order.  A NamedTuple (a train
state, an AdamW state) is rebuilt field by field.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def _is_namedtuple(t) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def _rebuild(like, children):
    """A list or tuple of ``like``'s type holding ``children``."""
    children = list(children)
    return type(like)(*children) if _is_namedtuple(like) else type(like)(children)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of ``rest``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return _rebuild(tree, (tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)))
    return fn(tree, *rest)


def tree_items(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) pairs, e.g. ``("groups/slot0/attn/wq", t)``, in leaf order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_items(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def tree_keystr_items(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(key, leaf) pairs in leaf order, each key the string
    ``jax.tree_util.keystr`` gives that leaf: ``['name']`` for a dict key,
    ``[i]`` for a list or tuple index, ``.field`` for a NamedTuple field,
    e.g. ``[1].adam.m['groups']['slot0']['attn']['wq']``."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_keystr_items(tree[k], f"{prefix}[{k!r}]")
    elif _is_namedtuple(tree):
        for name, v in zip(tree._fields, tree):
            yield from tree_keystr_items(v, f"{prefix}.{name}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_keystr_items(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def tree_leaves(tree) -> List[Any]:
    return [leaf for _, leaf in tree_items(tree)]


def tree_unflatten(like, leaves):
    """A tree shaped like ``like`` holding ``leaves`` (in :func:`tree_leaves` order)."""
    return _build(like, iter(leaves))


def _build(t, it):
    # a module-level function, not a recursive closure: a closure that calls
    # itself is a reference cycle, which would keep ``leaves`` (a step's
    # float32 gradients: 11.6 GB at mixtral-8x22b's one layer) alive until
    # the garbage collector runs
    if isinstance(t, dict):
        built = {k: _build(t[k], it) for k in sorted(t)}
        return {k: built[k] for k in t}
    if isinstance(t, (list, tuple)):
        return _rebuild(t, (_build(v, it) for v in t))
    return next(it)
