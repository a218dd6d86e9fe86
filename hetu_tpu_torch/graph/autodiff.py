"""Reverse-mode autodiff over the dataflow graph: the port of the JAX
package's ``graph/autodiff.py``.  A reverse topo walk calls each node's
``gradient()`` to build backward nodes and merges partial adjoints with
``SumOp``; sparse (IndexedSlices) adjoints of one table stay sparse and
are concatenated.  ``backward2forward`` / ``forward2backward`` map each
gradient node to its forward node and back."""

from __future__ import annotations

from .ops_embed import IndexedSlicesOp
from .ops_misc import OnesLikeOp, PlaceholderOp, SumOp


def find_topo_sort(node_list):
    visited = set()
    topo = []

    def dfs(n):
        if id(n) in visited:
            return
        visited.add(id(n))
        for i in n.inputs:
            dfs(i)
        topo.append(n)

    for n in node_list:
        dfs(n)
    return topo


def sum_node_list(node_list):
    node_list = [n for n in node_list if n is not None]
    if not node_list:
        return None
    if len(node_list) == 1:
        return node_list[0]
    if all(isinstance(n, IndexedSlicesOp) for n in node_list) and \
            len({id(n.inputs[0]) for n in node_list}) == 1:
        # several lookups into one table: keep the adjoint SPARSE by
        # concatenating (ids, rows); consumers merge duplicates
        from .ops_embed import merge_indexed_slices
        return merge_indexed_slices(node_list)
    return SumOp(node_list)


def gradients(output_node, node_list, insert_grad=None, return_all=False):
    """Build gradient nodes of ``output_node`` w.r.t. each node in
    ``node_list``.  ``insert_grad`` seeds a custom output adjoint."""
    if insert_grad is None:
        insert_grad = OnesLikeOp(output_node)
    node_to_grads = {id(output_node): [insert_grad]}
    node_to_grad = {}

    reverse_topo = list(reversed(find_topo_sort([output_node])))
    backward2forward = {}
    forward2backward = {}

    for node in reverse_topo:
        grads = node_to_grads.get(id(node))
        if grads is None:
            continue
        # merge partial adjoints; keep sparse adjoints sparse when single
        grad = sum_node_list(grads)
        if grad is None:
            continue
        node_to_grad[id(node)] = grad
        if isinstance(node, (PlaceholderOp, OnesLikeOp)):
            continue
        try:
            input_grads = node.gradient(grad)
        except NotImplementedError:
            from .node import vjp_gradient
            input_grads = vjp_gradient(node, grad)
        if input_grads is None:
            continue
        assert len(input_grads) == len(node.inputs), (
            f"{node}: gradient returned {len(input_grads)} for "
            f"{len(node.inputs)} inputs")
        forward2backward[node] = [g for g in input_grads if g is not None]
        for inp, g in zip(node.inputs, input_grads):
            if g is None:
                continue
            backward2forward[g] = (node, inp)
            node_to_grads.setdefault(id(inp), []).append(g)

    results = []
    for n in node_list:
        g = node_to_grad.get(id(n))
        assert g is not None, f"no gradient path from output to {n}"
        results.append(g)
    if return_all:
        return results, backward2forward, forward2backward
    return results
