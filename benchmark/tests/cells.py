"""Cells of BENCHMARK.json cut to a size the CPU runs in seconds."""

import copy

from benchmark import spec

TINY = {"num_hidden_layers": 2, "hidden_size": 128, "intermediate_size": 512}


def tiny(name: str, **mix) -> spec.Cell:
    """A cell of BENCHMARK.json cut to a size the CPU runs in seconds: two
    layers of width 128 (the vocab whole), 4 slots and clients, replies of
    4-24 tokens."""
    return shrink(copy.deepcopy(spec.cell(name)), **mix)


def shrink(cell: spec.Cell, **mix) -> spec.Cell:
    """`cell` cut in place as tiny() cuts a cell of BENCHMARK.json."""
    cell.config.update(TINY)
    cell.config["engine"]["max_streams"] = 4
    cell.traffic.update(clients=4)
    cell.traffic["prompt_tokens"].update(max=200)
    cell.traffic["output_tokens"].update(median=12, min=4, max=24)
    cell.traffic.update(mix)
    return cell
