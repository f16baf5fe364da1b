"""Graphviz emission helpers (counterpart of paddle_tpu/graphviz.py).
The dot-building machinery lives in debugger.py; this module keeps the
`fluid.graphviz` import path and the Graph-builder primitives over
plain text emission (no pydot binding)."""
from __future__ import annotations

from .debugger import program_to_dot, draw_block_graphviz  # noqa: F401

__all__ = ['GraphPreviewGenerator', 'program_to_dot',
           'draw_block_graphviz']


class GraphPreviewGenerator(object):
    """Minimal digraph builder (add_node/add_edge); __call__ writes the
    .dot file. Rendering it (`dot -Tpng`) is left to the caller."""

    def __init__(self, title):
        self.title = title
        self.nodes = []
        self.edges = []
        self._id = 0

    def add_node(self, label, prefix='node', description=None, **attrs):
        name = '%s_%d' % (prefix, self._id)
        self._id += 1
        self.nodes.append((name, label, attrs))
        return name

    def add_param(self, name, data_type, highlight=False):
        return self.add_node('%s\\n%s' % (name, data_type), prefix='param')

    def add_op(self, opType, **kwargs):
        return self.add_node(opType, prefix='op')

    def add_arg(self, name, highlight=False):
        return self.add_node(name, prefix='arg')

    def add_edge(self, source, target, **attrs):
        self.edges.append((source, target, attrs))

    def __call__(self, path='temp.dot', show=False):
        out = ['digraph "%s" {' % self.title]
        for name, label, attrs in self.nodes:
            a = ' '.join('%s="%s"' % kv for kv in attrs.items())
            out.append('  %s [label="%s" %s];' % (name, label, a))
        for s, t, attrs in self.edges:
            a = ' '.join('%s="%s"' % kv for kv in attrs.items())
            out.append('  %s -> %s [%s];' % (s, t, a))
        out.append('}')
        with open(path, 'w') as f:
            f.write('\n'.join(out))
        return path
