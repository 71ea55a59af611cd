"""Model families of the port (dense only so far) and the uniform API."""
