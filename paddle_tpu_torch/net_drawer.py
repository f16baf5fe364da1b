"""Network drawing CLI (counterpart of paddle_tpu/net_drawer.py):
render startup + main programs to a graphviz dot file.

    python -m paddle_tpu_torch.net_drawer --startup_proto s.json \
        --main_proto m.json --output network.dot
"""
from __future__ import annotations

import argparse
import json
import logging

from .graphviz import GraphPreviewGenerator

__all__ = ['draw_graph']

logger = logging.getLogger(__name__)

OP_STYLE = {'shape': 'oval', 'color': '#0F9D58', 'style': 'filled',
            'fillcolor': '#c0ebc0'}
VAR_STYLE = {'shape': 'box', 'color': '#999999', 'style': 'rounded'}


def parse_graph(program, graph, var_dict, **kwargs):
    """Add one program's ops/vars into a GraphPreviewGenerator."""
    for block in program.blocks:
        for op in block.ops:
            op_node = graph.add_op(op.type, **OP_STYLE)
            for names in op.inputs.values():
                for name in names:
                    if name not in var_dict:
                        var_dict[name] = graph.add_arg(name)
                    graph.add_edge(var_dict[name], op_node)
            for names in op.outputs.values():
                for name in names:
                    if name not in var_dict:
                        var_dict[name] = graph.add_arg(name)
                    graph.add_edge(op_node, var_dict[name])


def draw_graph(startup_program, main_program, path='network.dot',
               **kwargs):
    """Write a combined dot file and return its path."""
    graph = GraphPreviewGenerator('network')
    var_dict = {}
    parse_graph(startup_program, graph, var_dict)
    parse_graph(main_program, graph, var_dict)
    return graph(path)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--startup_proto', help='startup program json')
    parser.add_argument('--main_proto', help='main program json')
    parser.add_argument('--output', default='network.dot')
    args = parser.parse_args()
    from .framework import Program
    startup = Program.from_json(open(args.startup_proto).read())
    main_p = Program.from_json(open(args.main_proto).read())
    print(draw_graph(startup, main_p, args.output))


if __name__ == '__main__':
    main()
