"""Minimal R1CS constraint system + the reference test circuits.

Replaces the `ark-relations` usage in the reference (phase2/src/parameters.rs
:657-674 circuit_to_qap, phase2/src/helpers/testing.rs circuits). Variables
follow ark-relations indexing: instance variable 0 is the constant ONE;
global column index = instance index, or num_instance + witness index.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class Variable:
    kind: str  # "instance" | "witness"
    index: int


class LinearCombination(dict):
    """Sparse {Variable: coeff} map; supports v1 + v2 and coeff * v."""

    @classmethod
    def of(cls, *terms):
        lc = cls()
        for t in terms:
            if isinstance(t, Variable):
                lc[t] = lc.get(t, 0) + 1
            else:
                coeff, var = t
                lc[var] = lc.get(var, 0) + coeff
        return lc


class ConstraintSystem:
    """Setup- or prove-mode R1CS builder (ark ConstraintSystem analog)."""

    def __init__(self, r: int, setup: bool = True):
        self.r = r
        self.setup = setup
        self.num_instance_variables = 1  # the constant ONE
        self.num_witness_variables = 0
        self.instance_assignment: list[int] = [1]
        self.witness_assignment: list[int] = []
        self.a_rows: list[list[tuple[int, int]]] = []
        self.b_rows: list[list[tuple[int, int]]] = []
        self.c_rows: list[list[tuple[int, int]]] = []

    @property
    def one(self) -> Variable:
        return Variable("instance", 0)

    def new_input_variable(self, value=None) -> Variable:
        v = Variable("instance", self.num_instance_variables)
        self.num_instance_variables += 1
        if not self.setup:
            assert value is not None, "assignment missing"
            self.instance_assignment.append(value % self.r)
        return v

    def new_witness_variable(self, value=None) -> Variable:
        v = Variable("witness", self.num_witness_variables)
        self.num_witness_variables += 1
        if not self.setup:
            assert value is not None, "assignment missing"
            self.witness_assignment.append(value % self.r)
        return v

    def _col(self, v: Variable) -> int:
        return v.index if v.kind == "instance" else self.num_instance_variables + v.index

    def _row(self, lc: LinearCombination) -> list[tuple[int, int]]:
        entries = [
            (coeff % self.r, self._col(v)) for v, coeff in lc.items() if coeff % self.r
        ]
        entries.sort(key=lambda e: e[1])
        return entries

    def enforce_constraint(self, a: LinearCombination, b: LinearCombination, c: LinearCombination):
        # NB: columns are finalized at matrix-extraction time; rows store
        # Variables until then so inputs may be allocated after constraints
        self.a_rows.append(dict(a))
        self.b_rows.append(dict(b))
        self.c_rows.append(dict(c))

    @property
    def num_constraints(self) -> int:
        return len(self.a_rows)

    def to_matrices(self):
        """-> (a, b, c) as constraint-major [(coeff, var_col)] rows."""

        def conv(rows):
            return [self._row(LinearCombination(row)) for row in rows]

        return conv(self.a_rows), conv(self.b_rows), conv(self.c_rows)

    def full_assignment(self) -> list[int]:
        return self.instance_assignment + self.witness_assignment


def add_input_density_constraints(cs: ConstraintSystem) -> None:
    """x_i * 0 = 0 per instance variable, ensuring a fully dense IC query
    (parameters.rs:669-671)."""
    for i in range(cs.num_instance_variables):
        cs.enforce_constraint(
            LinearCombination.of(Variable("instance", i)),
            LinearCombination(),
            LinearCombination(),
        )


def circuit_to_qap(circuit, r: int) -> ConstraintSystem:
    """Setup-mode synthesis + input density constraints
    (parameters.rs:657-674). LCs are built inline, so ark's inline_all_lcs
    is the identity here."""
    cs = ConstraintSystem(r, setup=True)
    circuit.generate_constraints(cs)
    add_input_density_constraints(cs)
    return cs


# ---------------------------------------------------------------------------
# Reference test circuits (phase2/src/helpers/testing.rs)
# ---------------------------------------------------------------------------


@dataclass
class TestCircuit:
    """Knowledge of a square root: witness x, input out, 4x (x*x = out)."""

    __test__ = False  # not a pytest class
    x: int | None = None

    def generate_constraints(self, cs: ConstraintSystem) -> None:
        xv = cs.new_witness_variable(None if cs.setup else self.x)
        out_val = None if cs.setup else self.x * self.x
        out = cs.new_input_variable(out_val)
        for _ in range(4):
            cs.enforce_constraint(
                LinearCombination.of(xv),
                LinearCombination.of(xv),
                LinearCombination.of(out),
            )


@dataclass
class TestParallelCircuit:
    """A wider synthetic circuit for chunked-mode tests: k independent
    multiplication gates y_i = x_i * x_{i+1} (witnesses chained), with the
    products exposed as public inputs."""

    __test__ = False  # not a pytest class
    k: int = 8
    xs: list | None = None

    def generate_constraints(self, cs: ConstraintSystem) -> None:
        setup = cs.setup
        xs = self.xs if not setup else [None] * (self.k + 1)
        wit = [cs.new_witness_variable(None if setup else xs[i]) for i in range(self.k + 1)]
        for i in range(self.k):
            prod = None if setup else xs[i] * xs[i + 1]
            out = cs.new_input_variable(prod)
            cs.enforce_constraint(
                LinearCombination.of(wit[i]),
                LinearCombination.of(wit[i + 1]),
                LinearCombination.of(out),
            )

    def public_inputs(self, r: int) -> list[int]:
        return [self.xs[i] * self.xs[i + 1] % r for i in range(self.k)]
