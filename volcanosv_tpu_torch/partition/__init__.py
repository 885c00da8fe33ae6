from .partition import PartitionResult, partition_reads, hap_name
