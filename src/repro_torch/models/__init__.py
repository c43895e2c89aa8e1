"""Score networks and the components they are built from."""
