"""deposit_roofline.tsc: deposit_roofline in a TSC cell, 27 cells a
particle: the same kernel, reader and bytes (each operand read once and
each output written once, whatever the mass scheme)."""

import cell

read = cell.metric_reader("deposit_roofline")
