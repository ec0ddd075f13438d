"""The share of rows the Thruster wrapper masks as non-physical (NaN rows):
the program's counter rows_masked over rows_attempted, their changes over the
``htpem.predict`` spans of the traced window's completed calls. None where the
program keeps no spans or counted no row (:mod:`pembench.program`)."""

from pembench import program


def read(ctx):
    calls = program.call_spans(ctx) or []
    rows = program.counted(calls, "rows_attempted")
    return 100.0 * program.counted(calls, "rows_masked") / rows if rows else None
