"""Computation graphs (ported copies): the constraints hypergraph of the
local-search family, the pseudo-tree of DPOP and NCBB, and the ordered
graph of SyncBB."""
