"""The learning slice: exp2's interpolation trainer (train_interp.py), exp3's
GNN solver and its data (gnn.py, train_solver.py)."""
