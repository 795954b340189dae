"""The plain reference and the comparison that decides `correct`. Imports
torch and numpy only: nothing of the program under test and no JAX."""
