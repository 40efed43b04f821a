"""How the program's outputs of each family are read for the comparison
(``program/<family>.py``): the only files here that touch the program's
own structures."""
