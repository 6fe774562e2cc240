"""Set-up of a cell by model family: ``models/<family>.py`` builds the
program under test, its inputs and what the reference needs."""
