"""Matrix-free operators and problem generators."""
