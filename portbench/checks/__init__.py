"""The comparisons that decide ``correct``: what the timed path produced
against the plain references, each number beside its limit."""
