# launch: the serve driver (train driver and dry-run are later slices).
