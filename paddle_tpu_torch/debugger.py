"""Program/Block graphviz text (counterpart of paddle_tpu/debugger.py):
a Block's op/var dataflow as dot source, the same text as the JAX
package's for the same Program, with no graphviz binary needed (`dot
-Tpng` renders it wherever graphviz is installed).
`BuildStrategy.debug_graphviz_path` writes program_to_dot's text.
"""
from __future__ import annotations

__all__ = ['draw_block_graphviz', 'program_to_dot']


def _esc(s):
    return str(s).replace('"', r'\"')


def _var_label(var):
    shape = list(var.shape) if var.shape is not None else '?'
    return '%s\\n%s %s' % (_esc(var.name), _esc(var.dtype), shape)


def program_to_dot(program, skip_vars=None):
    """Whole-program dot: one cluster per block, op->var edges. Returns
    the dot source string."""
    out = ['digraph Program {', '  rankdir=TB;',
           '  node [fontsize=10, fontname="Helvetica"];']
    for block in program.blocks:
        out.append('  subgraph cluster_block_%d {' % block.idx)
        out.append('    label="block %d";' % block.idx)
        out.extend('    ' + line
                   for line in _block_body(block, skip_vars or ()))
        out.append('  }')
    out.append('}')
    return '\n'.join(out)


def _block_body(block, skip_vars):
    lines = []
    vid = {}

    def var_node(name):
        if name in skip_vars:
            return None
        if name not in vid:
            vid[name] = 'b%d_v%d' % (block.idx, len(vid))
            try:
                var = block.var_recursive(name)
                label = _var_label(var)
            except KeyError:
                label = _esc(name)
            lines.append('%s [shape=ellipse, label="%s"];'
                         % (vid[name], label))
        return vid[name]

    for i, op in enumerate(block.ops):
        op_id = 'b%d_op%d' % (block.idx, i)
        lines.append(
            '%s [shape=box, style=filled, fillcolor="#e8f0fe", '
            'label="%d: %s"];' % (op_id, i, _esc(op.type)))
        for names in op.inputs.values():
            for n in names:
                v = var_node(n)
                if v:
                    lines.append('%s -> %s;' % (v, op_id))
        for names in op.outputs.values():
            for n in names:
                v = var_node(n)
                if v:
                    lines.append('%s -> %s;' % (op_id, v))
    return lines


def draw_block_graphviz(block, path, skip_vars=None):
    """Write one block's dataflow as .dot to `path`."""
    body = ['digraph Block%d {' % block.idx, '  rankdir=TB;',
            '  node [fontsize=10, fontname="Helvetica"];']
    body.extend('  ' + line for line in _block_body(block, skip_vars or ()))
    body.append('}')
    with open(path, 'w') as f:
        f.write('\n'.join(body))
    return path
