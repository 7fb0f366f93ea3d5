"""Training recipes, one module a recipe, named by a configuration's
`recipe`: the loss the program is trained with, through the port's own
model API, and the batch it is handed."""
