"""The port's side of each configuration family: how a configuration
file becomes the port's model, training loss and engine. One module per
`family` named in a configuration file."""
