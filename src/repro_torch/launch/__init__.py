# launch: the serve, train and dry-run drivers.
