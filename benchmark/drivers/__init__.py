"""One driver per traffic kind, named by a mix's ``driver`` key: each
sets a cell up, measures its window, judges what the window produced and
returns the observations the metric readers take."""
