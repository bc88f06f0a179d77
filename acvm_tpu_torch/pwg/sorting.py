"""AS-Waksman-style routing for the PermutationSort directive.

Computes the control bits of a sorting network mapping ``inputs`` to
``outputs`` (reference: acvm/src/pwg/directives/sorting.rs, after the
construction in https://www.mdpi.com/2227-7080/10/1/16).  Host-side by design:
tiny, recursive, and data-dependent — the batched device solver calls into this
per-instance during planning/solve of sort directives.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from ..fields.field import FieldElement


class _SortingNetwork:
    def __init__(self, n: int):
        free_len = (n - 1) // 2
        self.n = n
        self.x_inputs: List[FieldElement] = []
        self.y_inputs: List[FieldElement] = []
        self.x_values: Dict[int, int] = {}
        self.y_values: Dict[int, int] = {}
        self.inner_x: List[FieldElement] = []
        self.inner_y: List[FieldElement] = []
        self.switch_x: List[bool] = []
        self.switch_y: List[bool] = []
        self.free: Set[int] = set(range(free_len))

    def init(self, inputs: List[FieldElement], outputs: List[FieldElement]):
        n = self.n
        assert len(inputs) == len(outputs) == n
        self.x_inputs = inputs
        self.y_inputs = outputs
        for i in range(n):
            self.x_values[int(self.x_inputs[i])] = i
            self.y_values[int(self.y_inputs[i])] = i
        self.switch_x = [False] * (n // 2)
        self.switch_y = [False] * ((n - 1) // 2)
        self.inner_x = [FieldElement.zero()] * n
        self.inner_y = [FieldElement.zero()] * n

        # Route the single wires up-front.
        self.inner_y[n - 1] = self.y_inputs[n - 1]
        if n % 2 == 0:
            self.inner_y[n // 2 - 1] = self.y_inputs[n - 2]
        else:
            self.inner_x[n - 1] = self.x_inputs[n - 1]

    def route_out_wire(self, y: int, sub: bool) -> int:
        if self.is_single_y(y):
            assert sub
        else:
            port = y % 2 != 0
            s1 = sub ^ port
            inner = self.compute_inner(y, s1)
            self.configure_y(y, s1, inner)
        x = self.x_values.pop(int(self.y_inputs[y]))
        if not self.is_single_x(x):
            port2 = x % 2 != 0
            s2 = sub ^ port2
            inner = self.compute_inner(x, s2)
            self.configure_x(x, s2, inner)
        return x

    def route_in_wire(self, x: int, sub: bool) -> int:
        assert not self.is_single_x(x)
        port = x % 2 != 0
        s1 = sub ^ port
        inner = self.compute_inner(x, s1)
        self.configure_x(x, s1, inner)

        y = self.y_values.pop(int(self.x_inputs[x]))
        if not self.is_single_y(y):
            port = y % 2 != 0
            s2 = sub ^ port
            inner = self.compute_inner(y, s2)
            self.configure_y(y, s2, inner)
        return y

    def configure_x(self, x: int, switch: bool, inner: int):
        self.inner_x[inner] = self.x_inputs[x]
        self.switch_x[x // 2] = switch

    def configure_y(self, y: int, switch: bool, inner: int):
        self.inner_y[inner] = self.y_inputs[y]
        self.switch_y[y // 2] = switch

    @staticmethod
    def sibling(index: int) -> int:
        return index + 1 - 2 * (index % 2)

    def take(self) -> Optional[int]:
        return min(self.free) if self.free else None

    def is_single_x(self, a: int) -> bool:
        n = len(self.x_inputs)
        return n % 2 == 1 and a == n - 1

    def is_single_y(self, a: int) -> bool:
        n = len(self.x_inputs)
        return a >= n - 2 + n % 2

    def compute_inner(self, idx: int, switch: bool) -> int:
        if switch ^ (idx % 2 == 1):
            return idx // 2 + self.n // 2
        return idx // 2

    def new_start(self) -> Tuple[Optional[int], int]:
        next_switch = self.take()
        if next_switch is not None:
            return next_switch, 2 * next_switch
        return None, 0


def route(inputs: List[FieldElement], outputs: List[FieldElement]) -> List[bool]:
    assert len(inputs) == len(outputs)
    n = len(inputs)
    if n == 0:
        return []
    if n == 1:
        assert inputs[0] == outputs[0]
        return []
    if n == 2:
        if inputs[0] == outputs[0]:
            assert inputs[1] == outputs[1]
            return [False]
        assert inputs[1] == outputs[0]
        assert inputs[0] == outputs[1]
        return [True]

    n1 = n // 2
    network = _SortingNetwork(n)
    network.init(inputs, outputs)

    out_idx = n - 1
    start_sub = True
    switch: Optional[int] = None
    start: Optional[int] = None

    while network.free:
        if switch is not None:
            network.free.discard(switch)

        in_idx = network.route_out_wire(out_idx, start_sub)
        if network.is_single_x(in_idx):
            start_sub = not start_sub
            start, out_idx = network.new_start()
            switch = start
            continue

        next_wire = _SortingNetwork.sibling(in_idx)
        out_idx = network.route_in_wire(next_wire, not start_sub)
        switch = out_idx // 2
        if start == switch or network.is_single_y(out_idx):
            start, out_idx = network.new_start()
            switch = start
        else:
            out_idx = _SortingNetwork.sibling(out_idx)

    result = list(network.switch_x)
    result.extend(network.switch_y)
    in_sub1 = network.inner_x[:n1]
    in_sub2 = network.inner_x[n1:]
    out_sub1 = network.inner_y[:n1]
    out_sub2 = network.inner_y[n1:]
    result.extend(route(in_sub1, out_sub1))
    result.extend(route(in_sub2, out_sub2))
    return result
