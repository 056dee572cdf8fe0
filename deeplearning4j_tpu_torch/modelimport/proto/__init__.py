"""The port's protobuf wire reader and the schema tables of the messages
the importers read (``wire.py``)."""
