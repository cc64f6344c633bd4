"""Command-line helpers of the port."""
