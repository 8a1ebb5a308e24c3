# launch: the serve and train drivers (the dry-run is a later slice).
