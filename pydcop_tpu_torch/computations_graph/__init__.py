"""Computation graphs (ported copies): the constraints hypergraph of the
local-search family."""
