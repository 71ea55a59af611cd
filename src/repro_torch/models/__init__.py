"""Model families of the port (the dense decoder, the paper's CNNs) and the
uniform API."""
