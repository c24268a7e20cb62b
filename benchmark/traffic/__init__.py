"""Traffic drivers: one module a driver, named in a cell's file."""
