"""Share of the traced slice's wall in which no operation ran on the card."""
from benchmark.readers import idle_pct as read  # noqa: F401
