"""Parameter-tree helpers: nested dicts, lists/tuples and NamedTuples of
tensors (the port's parameter, optimizer and checkpoint trees), walked in
JAX's order: dict keys sorted, sequences and NamedTuple fields in order,
``None`` an empty subtree."""

from __future__ import annotations


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def leaves_with_paths(tree, path=()):
    """``[(path, leaf)]`` in JAX's flattening order; a path is a tuple of
    dict keys (str), sequence indices (int) and NamedTuple fields
    (``("attr", name)``)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves_with_paths(tree[k], path + (k,))]
    if _is_namedtuple(tree):
        return [x for f in tree._fields
                for x in leaves_with_paths(getattr(tree, f), path + (("attr", f),))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in leaves_with_paths(v, path + (i,))]
    return [(path, tree)]


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def map_with_paths(fn, tree, path=()):
    """``fn(path, leaf)`` over ``tree``'s leaves, its structure kept
    (``None`` stays ``None``)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_with_paths(fn, v, path + (k,)) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(map_with_paths(fn, getattr(tree, f), path + (("attr", f),))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_paths(fn, v, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)


def tree_map(fn, tree, *rest):
    """``fn`` over corresponding leaves of trees of ``tree``'s structure."""
    others = [dict(leaves_with_paths(r)) for r in rest]
    return map_with_paths(lambda p, x: fn(x, *(o[p] for o in others)), tree)


def unflatten_like(tree, new_leaves):
    """``tree``'s structure with its leaves replaced by ``new_leaves``,
    given in flattening order."""
    paths = [p for p, _ in leaves_with_paths(tree)]
    mapping = dict(zip(paths, new_leaves, strict=True))
    return map_with_paths(lambda p, _: mapping[p], tree)
