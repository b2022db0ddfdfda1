"""The multi-device layer of the port: the member-dim layout over a
``torch.distributed`` device mesh (``sharding``) and the one module that
calls ``torch.distributed``'s collectives, counting every call
(``collectives``)."""
