"""The share of the traced window in which no operation ran on the card,
in %, on the clip cell: the quantity device_idle_pct.serve reads, read by
that reader."""
from benchmark.core.spec import metric_reader

read = metric_reader("device_idle_pct.serve").read
