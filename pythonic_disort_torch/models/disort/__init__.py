"""The discrete-ordinates solver: types, batched solve, flux evaluation."""
