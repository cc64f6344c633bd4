"""Infrastructure (ported copies): only what the device solvers import;
the agent runtime is not ported yet."""
