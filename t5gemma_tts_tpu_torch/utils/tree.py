"""Nested-container helpers for parameter and optimizer-state trees.

The port's trees are nested dicts (and lists and NamedTuples) of tensors,
laid out as the JAX package's pytrees. These helpers walk them in the order
``jax.tree_util`` does (dict keys sorted, sequences and NamedTuple fields in
order) and treat ``None`` as an empty subtree, as JAX does, so a LoRA
adapter tree that mirrors the parameters with ``None`` at every frozen
leaf has leaves only at its adapters.
"""

from __future__ import annotations

import ast
import re
from typing import Any, Callable, Dict, Iterable, Iterator, List, Tuple

Path = Tuple[Any, ...]


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def leaves_with_path(tree: Any, path: Path = ()) -> Iterator[Tuple[Path, Any]]:
    """(path, leaf) pairs in ``jax.tree_util`` order; paths hold dict keys,
    sequence indices and NamedTuple field names."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_path(tree[k], path + (k,))
    elif _is_namedtuple(tree):
        for k, v in zip(tree._fields, tree):
            yield from leaves_with_path(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_with_path(v, path + (i,))
    else:
        yield path, tree


def flatten(tree: Any) -> Tuple[List[Path], List[Any]]:
    """(paths, leaves) in :func:`leaves_with_path`'s order."""
    pairs = list(leaves_with_path(tree))
    return [p for p, _ in pairs], [leaf for _, leaf in pairs]


def unflatten(template: Any, values: List[Any]) -> Any:
    """``template``'s structure with ``values`` as its leaves, taken in
    :func:`flatten`'s order."""
    return _rebuild(template, iter(values))


def _rebuild(tree, it):
    if tree is None:
        return None
    if isinstance(tree, dict):
        out = {k: _rebuild(tree[k], it) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(_rebuild(v, it) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, it) for v in tree)
    return next(it)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (same structure); ``None`` subtrees stay ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_map_with_path(fn: Callable, tree: Any, path: Path = ()) -> Any:
    """``fn(path, leaf)`` over ``tree``'s leaves."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map_with_path(fn, v, path + (k,))
                            for k, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def keystr(path: Path) -> str:
    """``jax.tree_util.keystr``'s form for dict paths:
    ``['decoder']['layers']...``, ``[0]`` for a sequence index."""
    out = []
    for k in path:
        if isinstance(k, int):
            out.append(f"[{k}]")
        else:
            out.append(f"[{k!r}]")
    return "".join(out)


_KEY = re.compile(r"""\[('(?:[^'\\]|\\.)*'|"(?:[^"\\]|\\.)*"|\d+)\]""")


def parse_keystr(text: str) -> Path:
    """The path that :func:`keystr` wrote as ``text``."""
    keys = []
    pos = 0
    for m in _KEY.finditer(text):
        if m.start() != pos:
            break
        keys.append(ast.literal_eval(m.group(1)))
        pos = m.end()
    if pos != len(text) or not keys:
        raise ValueError(f"not a key path: {text!r}")
    return tuple(keys)


def from_paths(pairs: Iterable[Tuple[Path, Any]]) -> Dict[Any, Any]:
    """The nested dict whose leaves are ``pairs`` (path, leaf)."""
    root: Dict[Any, Any] = {}
    for path, leaf in pairs:
        node = root
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return root
