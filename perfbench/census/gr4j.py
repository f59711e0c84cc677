"""GR4J's operations and bytes a member and day.

Production store 28 (one of the two arms a day: the other is zero), the
routing input 2, the unit hydrographs (2 n1 - 1) + (2 n2 - 1) for register
lengths (n1, n2), the routing store, exchange and outflow 21; the
objective's sums 3 (squared error) or 8 (with the three further means).
"""

OBJECTIVE_OPS = {False: 3, True: 8}
PACKED_ROWS = 6          # x1, x2, x3, x4 and the two initial stores


def step_ops(uh):
    n1, n2 = uh
    return 28 + 2 + (2 * n1 - 1) + (2 * n2 - 1) + 21


def member_day_ops(uh, stats):
    """Operations of one member over one day, with the objective's sums."""
    return step_ops(uh) + OBJECTIVE_OPS[stats]


def objective(members, days, uh, stats, catchments=1, itemsize=4):
    """(operations, bytes) of one objective launch: ``members`` members over
    ``days`` days of ``catchments`` catchments' series (prec, etp, qobs),
    one output row (squared error) or four (``stats``) per member and
    catchment; a regional launch also reads one valid count a catchment."""
    ops = member_day_ops(uh, stats) * members * days * catchments
    values = (3 * days * catchments + PACKED_ROWS * members
              + (4 if stats else 1) * members * catchments
              + (catchments if catchments > 1 else 0))
    return ops, itemsize * values
