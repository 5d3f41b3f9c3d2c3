"""Parameter conversion into the port's layouts."""
