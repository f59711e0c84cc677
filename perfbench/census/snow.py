"""CemaNeige (hysteresis, ice) before GR4J: operations and bytes a member
and day.

A layer's snow step 20 operations (32 with hysteresis), its ice melt 5 and
its share of the layer sum 1; 2 a day for the mean and the ice term; then
GR4J's step (:mod:`.gr4j`) and the objective's four sums (8, always formed).
"""

from perfbench.census import gr4j

LAYER_OPS = {False: 20, True: 32}
ICE_OPS = 5
SUMS_OPS = 8
PACKED_ROWS = 11


def member_day_ops(layers, hyst, ice, uh):
    per_layer = LAYER_OPS[hyst] + (ICE_OPS if ice else 0) + 1
    return layers * per_layer + 2 + gr4j.step_ops(uh) + SUMS_OPS


def objective(members, days, layers, hyst, ice, uh, stats, itemsize=4):
    """(operations, bytes) of one objective launch over (T, L) layer
    forcing: the solid and liquid precipitation and the temperature of
    every layer, etp, qobs, the layers' constants and ice fractions, the
    packed members and one (or, ``stats``, four) output rows."""
    ops = member_day_ops(layers, hyst, ice, uh) * members * days
    values = (3 * days * layers + days + 2 * layers + days
              + PACKED_ROWS * members + (4 if stats else 1) * members)
    return ops, itemsize * values
