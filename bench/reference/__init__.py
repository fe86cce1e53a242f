"""Plain references: nothing here imports the program."""
