"""How a cell's system is set up, driven and checked, by the cell's
``system`` key: ``serve`` (the port's ``ServeEngine`` session) and
``train`` (the port's ``make_train_step``)."""
